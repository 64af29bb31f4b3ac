// Host helpers of the columnar lowering (C ABI, loaded with ctypes).
//
// The port's own copy of the JAX package's native/columnar.cc, with the
// same three functions and the same C interface. Python gathers each
// row's ids into flat CSR-style arrays; these loops do the per-row
// packing and the greedy occupancy sweep that dominate lowering at
// 50,000 pods. Built with g++ by kubernetes_tpu_torch/ops/build.py
// (`build_host`); bound by kubernetes_tpu_torch/native.py, which checks
// every index against its bounds before a call. The NumPy versions in
// kubernetes_tpu_torch/models/columnar.py are the plain versions the
// tests hold these to.

#include <cstdint>

extern "C" {

// Pack per-row id lists (CSR: ids offsets[i] .. offsets[i + 1]) into
// uint32 bitset rows: out[n_rows][words], zeroed by the caller.
void pack_bitsets(int64_t n_rows, int64_t words, const int64_t* offsets,
                  const int32_t* ids, uint32_t* out) {
    for (int64_t i = 0; i < n_rows; ++i) {
        uint32_t* row = out + i * words;
        for (int64_t k = offsets[i]; k < offsets[i + 1]; ++k) {
            const int32_t id = ids[k];
            row[id >> 5] |= (uint32_t)1 << (id & 31);
        }
    }
}

// OR per-pod bitset rows into their node's row:
// node_rows[node_idx[i]] |= pod_rows[i] (node_idx < 0 skipped).
void or_rows_by_index(int64_t n_pods, int64_t words, const int32_t* node_idx,
                      const uint32_t* pod_rows, uint32_t* node_rows) {
    for (int64_t i = 0; i < n_pods; ++i) {
        const int32_t j = node_idx[i];
        if (j < 0) continue;
        const uint32_t* src = pod_rows + i * words;
        uint32_t* dst = node_rows + (int64_t)j * words;
        for (int64_t w = 0; w < words; ++w) dst[w] |= src[w];
    }
}

// The assigned-pod occupancy sweep, in list order (the reference's
// MapPodsToMachines / CheckPodsExceedingCapacity, predicates.go:116-136,
// and calculateOccupancy, priorities.go:44-58): every pod adds to the
// full usage sums; a pod that does not fit the greedy-fitted sums marks
// its node overcommitted instead of adding to them. f32 throughout, one
// rounding per add, as the NumPy version.
void greedy_fit(int64_t n_pods, const int32_t* node_idx, const float* cpu,
                const float* mem, const float* cpu_cap, const float* mem_cap,
                float* cpu_fit, float* mem_fit, uint8_t* over, float* cpu_used,
                float* mem_used, float* pods_used) {
    for (int64_t i = 0; i < n_pods; ++i) {
        const int32_t j = node_idx[i];
        if (j < 0) continue;
        const float c = cpu[i], m = mem[i];
        cpu_used[j] += c;
        mem_used[j] += m;
        pods_used[j] += 1.0f;
        const bool fits_cpu = cpu_cap[j] == 0.0f || cpu_fit[j] + c <= cpu_cap[j];
        const bool fits_mem = mem_cap[j] == 0.0f || mem_fit[j] + m <= mem_cap[j];
        if (fits_cpu && fits_mem) {
            cpu_fit[j] += c;
            mem_fit[j] += m;
        } else {
            over[j] = 1;
        }
    }
}

}  // extern "C"
