#!/usr/bin/env python3
"""Build the PyTorch/CUDA port and drive it on one CUDA card.

    python3 chip_smoke.py

Run from the root of a checkout. It imports only `kubernetes_tpu_torch`
and needs one card; without CUDA, or without the package beside it, it
exits non-zero and prints no result. Phases, one JSON line each:

  1. device   the card, its power limit, torch and CUDA versions;
  2. build    nvcc of every kernel under kubernetes_tpu_torch/csrc/ and
              g++ of the host lowering helper (csrc/columnar.cc), all
              sources at once;
  3. parity   each kernel held against its plain PyTorch version on the
              card, exactly (torch.equal on the decisions and all nine
              carry fields): seeded small clusters, non-default weights,
              repeated service ids, multi-word bitsets, the scan
              cluster's edges (an unpadded node axis of 5,121, fewer
              nodes than CTAs, crowded services, unplaceable pods between
              placed ones), then the 50k x 5k backlog chunk by chunk (all
              of it when the plain loop fits its budget, else the first
              pipeline chunk; the line says which);
  4. repeat   the scan kernel five times on the first 50k x 5k chunk:
              every run's decisions and carry equal the checked ones (a
              race between the cluster's CTAs shows up as a difference);
  4b. parity_in_place
              the scan kernel with its slices in device memory, held
              exactly to the plain version: small clusters forced in
              place on 1, 4 and 16 CTAs, the first 1,024 pods of that
              chunk forced in place (twice), 1,024 pods on 50,000 nodes
              (past the 40,384 a cluster holds resident; the default
              plan) and the runtime-width instance (4-word bitsets) on
              30,000 nodes (past the session's 27,840);
  5. main     solve_backlog_pipelined on synthetic_objects(50000, 5000,
              seed=2+r): a warm-up and two timed runs, with the phase
              times, pods placed and kernel launches of each (the
              kernel ledger's launch count equal to the wrapper's); then
              schedule_backlog once. Every run's names must equal the
              plain version's where phase 3 checked them. Device memory
              in use and at peak after the runs, and `lower` split into
              its steps (lower_split: vocabularies, pod
              columns, node columns and the assigned sweep within them,
              service seeds, the rest; least of three rounds);
  5a. native  the g++ helper on every call the lowering makes for the
              backlog's pod columns and for the node columns of the
              churn session's 50,000 assigned pods: each output equal to
              the NumPy version's exactly; g++'s seconds, each helper's
              ms against NumPy's;
  5b. churn   BASELINE config 5 on the incremental SolverSession: the
              5,000 nodes and 500 services of that backlog, its pods as
              the first main run placed them as the assigned pods,
              node_capacity 6,250, prewarm to the 1,024-pod bucket, then
              2 warm-up and 10 timed ticks of 1,000 creates and 1,000
              random deletes (workload.churn_replay). Per tick the wall,
              the phases, the kernel's ms by CUDA events; after every
              tick the device rows equal the host mirror wherever no
              delta is pending; on timed ticks 1, 5 and 10 the kernel's
              choices and carry equal the plain version's on clones of
              that tick's inputs. The same operations are replayed on a
              fresh session with solve_async (a tick in flight while the
              next tick's deltas land) and must give the same results.
              Last, solve_gang on one more tick with groups, against the
              same tick on the replayed session with the plain version
              in place of the kernel; the kernel timed at the session's
              shape; the duty cycle and overlap of both runs' timed
              ticks (this phase's own figure: the registry's series are
              the daemon's, phase 5o); and one more tick's solve under
              torch.profiler (busy share);
  5c. gang    schedule_backlog_gang on seeded small clusters with groups
              on the card against device="cpu" (destinations, accepted
              and rejected keys), then on the 50k x 5k backlog in groups
              of 50, some of which cannot reach minMember: all or
              nothing, with at least two rounds;
  5d. policy_parity
              the policy scan kernel held against its plain version on
              the card, exactly (decisions, the nine carry fields, anchor
              and svc_total), each case at the default plan, on clusters
              of 1 and 4 CTAs, and on 16 CTAs with the slices read in
              place: every policy of workload.POLICY_SHAPES on seeded
              small clusters (BASELINE configs 2 and 3, label presence
              and absence, label preference, service affinity with an
              anchor on an unknown node, one and two anti-affinity
              instances, the full vocabulary), and the cluster's edges
              (ties across CTAs with unplaceable pods between placed
              ones, zones with nodes in every CTA, anchors in other CTAs,
              fewer nodes than CTAs, an instance of weight 0, crowded
              services), and past the eight anti-affinity instances and
              eight affinity labels the kernel keeps in its arguments
              and registers (9 and 12 instances, 9 labels, both at once,
              and 9 instances on 5,000 nodes);
  5e. policy  schedule_backlog(spec=FULL_VOCABULARY_POLICY) on
              policy_objects(50000, 5000, seed=2): a warm-up and two
              timed runs (wall, phases, launches; the runs' names
              identical; one policy kernel launch each, on a cluster of
              more than one CTA), the kernel's ms by CUDA events on the
              whole backlog, the launch plan and its occupancy, and the
              first 4,096 pods held to the plain version on the card,
              decisions and carry;
  5f. explain explain_backlog for 1,024 pods of that backlog against its
              5,000 nodes on the card, equal to the same call with
              device="cpu";
  5h. wave    the wave solver (plain PyTorch, no hand kernel):
              solve_backlog_pipelined(mode="wave") on the 50k x 5k
              backlog, a warm-up run, whose regret against the greedy
              replay (scored in a child process while Sinkhorn's
              warm-up and both modes' card-against-CPU cases run) is
              held within TestWaveQuality's bounds; on the card
              against the CPU,
              exactly (assignment, carry, waves), on seeded small
              clusters at windows 32 and 4,096 and on an 8,192 x 1,024
              backlog; two timed runs of the 50k backlog (wall,
              phases, waves, pods placed, validity by the port's
              oracle); then two churn ticks of
              the session in wave mode, the device rows equal to the host
              mirror after each;
  5i. sinkhorn the same for Sinkhorn, card against CPU within its
              rounding (decisions agreeing on 99% of the pods; the
              congestion prices of the same inputs within 1e-4 and the
              iterations run equal), with iterations and the residual,
              and TestSinkhornQuality's bounds;
  5g. sidecar python -m kubernetes_tpu_torch.ops.sidecar as a subprocess
              on the card, sent the default 50k backlog and the policy
              backlog by the port's SidecarSolver: the answers equal the
              in-process schedule_backlog's; round-trip seconds and frame
              bytes; the default backlog in modes wave and sinkhorn, each
              answer equal to the same solve in this process; a ping
              after a garbage frame still answers; then one default
              pair against the port's server on a thread of this
              process, with the server's spans of each trip (recv,
              decode, upload, solve, send) from its trace buffer;
  5j. preemption
              victim selection (plain PyTorch) on
              workload.preemption_objects(5000, 50000, 1000): a priority
              burst on a fleet filled to 85-100% of a resource; seed 2 a
              warm-up and two timed runs (wall, build and solve, ms a
              preemptor, grants, victims), seed 3 once, each seed's card
              decisions equal to its CPU run's, one seed-2 solve under
              torch.profiler (the card's busy share); the card equal to
              the port's scalar rule on 16 small seeded problems and on
              200 nodes x 2,000 bound pods x 32 preemptors (the scalar is
              O(N x V) a preemptor, so not at full size);
  5k. capacity
              capacity_report (plain PyTorch) on the occupancy columns of
              the main path's placement (cluster_columns) and of the
              churn session after its replay (session_columns), probes
              DEFAULT_SLICE_SHAPES and the 50k backlog's p50, p90, max:
              card, CPU and the port's NumPy twin equal on every output,
              dtypes included; median ms; one call under torch.profiler
              (its kernels and the card's busy share);
  5l. rebalance_parity
              the defrag plan kernel (K2) held to its plain version on
              the card, exactly, on clusters of 1, 2, 4, 8 and 16 CTAs
              (every size its plan chooses), at the default K and at
              K = 1, resident and in place: 16 seeded worklists (N 1-300,
              Q 1-12, sources out of range, dead and forced rows, budgets
              0 to D + 3), the consolidation case, no rows, ties across
              every warp at 300 and 5,000 nodes, and 70 probes (the
              gain's lanes loop);
  5m. rebalance
              utils.rebalance.build_plan on five worklists: the main
              path's placement, all 50,000 pods movable, at budget 32
              (the descheduler's), at budget D, with 50 forced
              (cordoned) nodes and with every node forced (every row
              commits: the dense case), all at budget D but the first;
              and a full fleet (preemption_objects(5000, 50000, 0,
              seed=2), 48,998 movable pods) at budget D. Per case the
              wall and its phases (stage, plan, group), K2's ms by CUDA
              events and its us a row, its commits, windows, rows
              screened and the screen/resolve split of its cycles (the
              kernel's stats), and every output of K2 equal to the
              port's NumPy twin on the whole worklist (the twins run in
              child processes, after the walls), the plan equal to the
              plan of the twin's rows; K2 held to its plain version
              on the card on the first 2,048 rows of budget D (the plain
              loop is a launch sequence a row); K2 on budget D, 50
              forced nodes and the full fleet on clusters of 4, 8 and 16
              CTAs, K from 1 to 32 and windows of up to 2,048 rows, each
              equal to the default plan's outputs;
  5n. telemetry
              the kernel ledger's rows (calls, builds and their seconds,
              cost per shape); two more default backlog runs under
              torch.profiler (the card's busy share, and whether the
              trace saw every K1 launch the ledger counted) with their
              h2d and d2h bytes (d2h exactly the padded choices); one
              more with CUDA events around each K1 launch (K1's share
              of the wall, read without the profiler); device memory
              after the main path; the churn ticks' duty cycle and
              overlap and the profiled tick's busy share; the series as
              the metrics registry holds them (no daemon has fed the
              duty and overlap series yet: their count is 0);
  5p. mesh    the node-sharded mesh (`ops.matrices.host_mesh`): four
              shards on cuda:0-3 with four or more cards, else four
              shards on cuda:0 (line `mesh_devices` says which, with the
              device count). The shard-step kernel K1S on the first 4,096
              pods of the 50k x 5k backlog (5,120 nodes, 1,280 a shard)
              held exactly to its plain version (the eager shard step)
              and to K1's unsharded solve, decisions and carry; K1S
              timed (median of two, per pod too) with its launches;
              `schedule_backlog(mesh=)` on those pods against the
              unsharded one, its K1S launches counted; the wave over the
              whole 50k x 5k backlog (`solve_backlog_pipelined(mode=
              "wave", mesh=)`) equal to the unsharded wave; Sinkhorn the
              same with at least 99% of the pods agreeing, its sharded
              prices within 1e-4 of the unsharded ones, and its
              placements on an 8,192 x 1,024 backlog valid by the
              oracle; `resolve_batch_mode("auto", mesh)` must pick the
              wave, and `schedule_backlog_wave(mesh=)` on that backlog
              equal the unsharded one. Walls, device memory at peak;
  5o. daemon  the port's scheduler daemon against the port's apiserver,
              started for each leg as a child process (`python -m
              kubernetes_tpu_torch.cmd.hyperkube apiserver`, store in
              memory; nothing of it is imported here; each leg fails if
              the child holds a CUDA context, read from nvidia-smi's
              compute apps and the child's mapped libraries) on 5,000 nodes
              of the JAX package's churn drill: daemon_parity, 1,024
              pending pods (a nodeSelector on every eighth) created over
              HTTP, one schedule_batch() of a daemon that was not
              started, its bindings read back by LIST equal to
              schedule_backlog's and the plain K1 version's on the same
              pods; daemon_parity_wide, the same with a hostname label
              on every node (5,004 label tokens) and a disk of its own
              on every tenth pod, which the session's vocabularies are
              sized for (pod rows of 224 words, K1 in place);
              daemon_drill, the pod-to-bind drill (bench.py's
              shape): the daemon started with its own HTTP transport,
              a spawned load generator creating 1,000 pods/s from two
              paced threads and deleting down to a cushion of 200 bound
              pods, 2 s warm-up, a 6 s window, up to 10 s for the
              window's pods to bind (latency: create call start to the
              binding on the generator's own watch), the collector
              frozen before the window; daemon_churn, the same after
              50,000 pods were created and bound round-robin, the
              deleter taking the oldest first. Each drill prints bound
              pods/s, latency p50/p99/max, the window's unbound pods,
              ticks and pods a tick, K1 launches and ms a tick, duty
              cycle and overlap, phase seconds, bind_bulk latency,
              informer staleness, the apiserver's CPU seconds beside
              this process's, and the collector's passes; it fails on a
              pod bound twice, an invalid final placement (the port's
              oracle, every bound pod counted), a session that differs
              from one rebuilt from the LIST, a device error, or a pod
              still unbound 30 s after the window. Four more legs, each
              on a fresh child: daemon_parity_hostnames, the wide leg on
              8,000 nodes (8,004 label tokens: K1's pod rows of about
              340 words, past the two 128-pod tiles, staged 64 pods a
              tile with the slices in place), its K1 plan and ms;
              daemon_policy_parity, 5,000 nodes labelled as
              workload.policy_objects labels them, its services and
              bound peers, 1,024 pending pods and one schedule_batch()
              of a non-started full re-lower BatchScheduler under
              FULL_VOCABULARY_POLICY, its bindings equal to
              schedule_backlog(spec=...)'s and the plain K1P version's,
              one K1P launch; daemon_policy_drill, the drill's load
              against that daemon started (the same figures and checks
              but the session's, and `lower` a tick); and
              daemon_sidecar_parity, the port's sidecar as a child on
              the card and a non-started BatchScheduler solving 1,024
              pods through it, equal to schedule_backlog's, the sidecar
              reporting one K1 launch. Every daemon samples the capacity
              plane each tick: the parity legs hold the monitor's
              snapshot to the plain report on the session's columns,
              the drills report the `capacity` phase a tick and its
              share of the window. Every daemon feeds the flight
              recorder (explain limit 64, every trace sampled):
              daemon_parity holds one decision a pod to its binding and
              the verdict tables of the tick's first 64 pods (unbound
              first) to explain_backlog on the CPU, exactly, naming the
              pod, the node and both values where they differ; the
              drills hold every window pod still in the ring to a
              `bound` decision at its binding's node and report the
              `explain` phase and the record time a tick beside
              `capacity`. Two more legs, each on a fresh child
              at 5,000 nodes with the incremental daemon started:
              desched_defrag, every node keeping a 2,000m shard (15,000
              bound pods), 16 pending pods of 3,000m, the slice shape
              configured, and one cycle of the port's Descheduler
              (grace 0, disruption cap 16): each cycle's K2 plan equal
              to the plain version's on the same inputs, the cap held,
              every replacement bound at its destination within 30 s,
              no pod name lost or bound twice, no journal left, nothing
              stranded, the measured score lower at the end, the
              pending pods bound; with each cycle's wall by phase, ms a
              move, eviction to rebind p50 and p99, K2 ms by CUDA
              events, K2 and K1 launches; autoscale_cycle, the nodes
              filled to 500m free, a burst of 64 pods of 2,000m, the
              port's Autoscaler (grow_after 2, grow_step 64) polled
              over a hollow node pool until it grows and the burst
              binds on the new nodes, then fillers and burst deleted
              (one small pod a node) and polled (shrink_after 2)
              through cordon, drain (K2, the node forced) and shrink:
              the drained pod bound elsewhere, the node gone, the pool
              one smaller, no pod lost; poll walls, grow to bound and
              drain to retire seconds; desched_defrag also holds each
              executed move to a `rebalance_nominated` record at its
              destination. Last, daemon_debug: the port's command
              (`python -m kubernetes_tpu_torch.cmd.scheduler --batch
              --server URL --healthz-port PORT`) as a child on the card
              over 5,000 nodes, 1,024 pods that fit and 8 whose cpu
              request is above every node's, read only over HTTP:
              /healthz ok; /metrics counting 1,024 bound decisions;
              /debug/decisions with each fitting pod's newest record
              bound at its LIST binding, each stuck pod's unschedulable
              with 0 of 5,000 nodes feasible and PodFitsResources among
              its reasons, verdict tables on the newest tick's bound
              pods (at most 64 a tick), the bare-name filter; solve
              records covering the 1,032 pods; a trace naming a pod;
              K1's launches in the load (less the session prewarm's,
              read once they settle) at least the solve records; capacity
              sampled; an SLOReport; a device profile's directory; exit
              0 on SIGTERM. It reports the command's ticks, K1 ms a
              launch from that profile, the `explain` phase and the
              time to settle. Then the failover legs, on 5,000 nodes
              and 5,000 bound pods: daemon_failover, two rounds of a
              WarmStandbyScheduler prewarmed on the card (informers
              synced, session built with its 128-bucket warm
              launches), the active one killed, a pod created and the
              standby activated: kill to first bind p50 and p99 with
              the failover_to_first_bind_s verdict (reported), the
              prewarm's sync and build, K1 launches by the prewarm and
              the first tick and K1 ms there, device memory each round;
              each round's pod bound once at the node the card's
              schedule_backlog gives on the LISTed cluster, memory
              within two sessions' worth; daemon_ha, two HAScheduler
              replicas (lease 2 s, renew 0.5 s), the leader crashed:
              kill to first bind, grant to running, the deposed
              replica's rebuild; at most one active daemon and one
              valid token at every sample, the token bumped, the
              deposed replica warm and idle, every pod bound once;
              daemon_ha_cmd, two commands with --batch --leader-elect,
              the leader killed with SIGKILL: kill to first bind split
              into the lock's wait and the rival's cold start, one
              holder in the kube-scheduler lock at every read, a then
              b, every pod bound once, b's /healthz 200. Last,
              daemon_scalar: the per-pod Scheduler over 32 pods on
              5,000 nodes, pods a second, its bindings in pop order
              equal to the card's schedule_backlog in that order. Then
              apiserver_durable: the apiserver with --data-dir (fsync
              before every ack), 5,000 nodes and daemon_parity's 1,024
              pods bound by one schedule_batch() (equal to
              schedule_backlog's), SIGKILLed and restarted on the same
              directory: every node and pod LISTed after the restart
              equal to the LIST before the kill, the next write's
              resourceVersion above the last acked one; the create p50
              and p99 with fsync and in memory, the restart's seconds to
              /healthz, the WAL and snapshot bytes. Then the replicated
              control plane and the controller-manager:
              apiserver_replicated, a leader and two followers, each a
              child running REPLICA_LAUNCHER on a durable directory
              with fsync, 5,000 nodes and the 1,024 parity pods created
              through f1 (forwarded, acked at quorum) and bound by one
              schedule_batch() of the daemon whose transport lists f1,
              f2 and the leader (equal to schedule_backlog's, the three
              LISTs equal), 256 forwarded single creates timed, the
              leader SIGKILLed, a write through f2 failing fast, f1
              promoted with f2 rejoined as its follower, 64 more pods
              created and bound; every binding acked before the kill on
              f1, f1 and f2 equal; controller_rc, `hyperkube
              controller-manager` as a child over 5,000 nodes, 10 RCs
              of 500 replicas bound by the started daemon (every
              replica bound, status.replicas 500, no node over
              capacity), one RC scaled to 100; create to bind p50 and
              p99, bound pods a second, the controller-manager's CPU
              seconds; controller_node_loss, 16 port kubelets on the
              fake runtime (heartbeat 1 s; 15 in one child of
              HOLLOW_LAUNCHER, n0 in its own), grace 4 s and eviction 2
              s, an RC of 32 replicas, n0's child SIGKILLed: the seconds
              from the kill to its NotReady, to its pods' eviction and
              to all 32 bound again elsewhere and Running, beside n0's
              last stored heartbeat. Then the node side:
              kubelet_density, the reference's density e2e (100 port
              kubelets on the fake runtime in one HOLLOW_LAUNCHER child
              at JAX's defaults, the controller-manager child at its
              defaults, one RC of 3,000 replicas of 100m and 16Mi, then
              scaled to 1,500): every node registered by its kubelet,
              Ready and heartbeating, every pod Running with an IP and
              ready containers, no node over capacity, abnormal pods at
              most 1%, the removed pods gone from the apiserver and the
              kubelets' runtimes; the kubelets' start to all
              registered, create to bound and to Running (p50, p99,
              max; the 5 s SLO reported), bound to Running, Running
              pods a second, the scale-down, the children's CPU
              seconds; kubelet_service, two `hyperkube kubelet
              --container-runtime process` children, three pods running
              ECHO_LAUNCHER with a secret volume, a named port and an
              HTTP readiness probe behind a service, a ProxyServer
              without real portals here and a `hyperkube proxy
              --no-real-portals` child: each pod anchored by the
              port-built pause, 30 requests through the portal answered
              10 by each pod with the secret, the apiserver's service
              proxy and log relay answered, echo-0 deleted (its
              processes gone, dropped from Endpoints, the next 20
              requests 10 by each of the others); create to Running
              and to ready in Endpoints, delete to dropped and to gone,
              a request's latency. No replica, kubelet, proxy or
              controller-manager child holds a CUDA context or maps
              libtorch, and the local addresses and mounts are as they
              were. Then the cloud and the whole cluster:
              cloud_controllers, `hyperkube controller-manager
              --cloud-provider gpu` as a child (it reads the card
              inventory): node gpu-host-0 registered with the cards'
              name and count as nvidia-smi lists them, a LoadBalancer
              service's ingress published, a podCIDR on the node synced
              by the route controller, the ingress cleared by a type
              change and the deleted service synced, no sync error,
              exit 0 on SIGTERM; the child's start to the registration,
              create to ingress and the other steps' seconds;
              local_up, `hyperkube local-up-cluster --batch-scheduler
              --nodes 4 --kubelet-http --cluster-dns --no-kube-proxy
              --port 0` as a child on the card: an RC of 200 replicas
              Running on its kubelets, K1 launched in the child past its
              prewarm (its /debug/kernels), the RC's service resolved by
              the DNS addon on the port the child printed, SIGINT to
              exit 0 with no process of its group left; create to
              Running p50 and p99, K1's launches; ktctl, the port's CLI
              (`python -m kubernetes_tpu_torch.cli`, a fresh process a
              command, the server found through its kubeconfig) against
              `hyperkube local-up-cluster --batch-scheduler --nodes 2
              --kubelet-http --process-runtime --no-kube-proxy --port 0`
              as a child on the card: config, create -f (an RC of 3 and
              a service, JSON) to Running through K1 in the child,
              explain, top nodes and capacity, logs, exec, a
              port-forward child answering a GET, scale to 4,
              rolling-update --image, stop leaving no pod in the
              apiserver or the runtimes, SIGINT to exit 0; each
              command's wall (p50, max), create and scale to Running,
              the rolling update's and the stop's walls, K1's launches;
              soak, last, in this process with the port's lock sanitizer
              on from before the cluster is built: the port's hollow-node
              soak (`kubernetes_tpu_torch.soak.run_soak`, 200 nodes, seed
              7, fsync on a temporary data dir, the incremental daemon,
              the descheduler and the autoscaler on the card) over
              SOAK_EPOCHS (`--soak-epochs all` the full 11) with its
              seeded fault schedule; zero invariant violations, every
              expected alert fired and resolved, the apiserver and the
              daemon restarted, K1's and K2's ledger calls risen, no
              sanitizer finding and no lock held by a dead thread, no
              non-daemon thread left, the registry disarmed, and each
              armed site fired where its rule and seeded stream say;
              each epoch's wall, binds and bind p99, firings per site,
              K1 and K2 launches, the sanitizer's locks and edges;
  6. kernels  per kernel: launches on the main path, its time by CUDA
              events at the main path's shape, the plain version's time
              on the same inputs, and the bound for that work; for the
              scan kernel also sweeps over the node count, the cluster
              size and the threads per CTA (each configuration's result
              equal to the checked one), a run with no service ids (no
              count commits), a node axis near the shared-memory limit,
              timed once, and a `launch` line per configuration (cluster size,
              shared memory, cudaOccupancyMaxActiveClusters, registers
              and spills from ptxas); for the policy scan kernel its µs a
              pod at 1,024, 5,120 and 20,480 nodes, with no anti-affinity,
              one instance and the full vocabulary, on clusters of 1, 4,
              8 and 16 CTAs (each equal to the default plan's result),
              and a split of its step: the scan kernel and the policy
              kernel on the same pods under specs that add the service
              carry, service affinity and anti-affinity one at a time;
              for the defrag plan kernel (K2) its time, the plain
              version's and the bound on the same first 2,048 rows of
              budget D, beside its time and bound on each of phase 5m's
              worklists, and its launches counted over each of the
              phases 5j-5m.

Every phase line carries the script's seconds so far (`elapsed_s`).
The run fails if any module of the JAX package was loaded into this
process. Then the card's name and power limit, and last the result line
{"ok": true, "device": {...}}. Any failure ends the run with a non-zero
exit before the result line.

    python3 chip_smoke.py --host-timing [--root DIR] [--runs N]

times only the host work around the card, with the package imported
from DIR (default: this checkout), through the same functions the
phases above use: the backlog (phase 5's runs) and the policy backlog
(phase 5e's), each with the collector on and then off, `lower_split` of
the default backlog, the policy backlog and the churn cluster's
assigned pods alone, and the churn ticks' phases (phase 5b's
synchronous replay). One JSON line a measurement. Two checkouts are
compared by running it in turns in one command (A B B A).

    python3 chip_smoke.py --mesh

builds the kernels and runs phase 5p alone, then its kernel line.

    python3 chip_smoke.py --daemon

builds the kernels and runs phase 5o alone (twenty-four lines, no
result line); `--daemon-legs daemon_churn,daemon_debug` runs only those legs,
and `--churn-stuck N` creates N pods that fit no node before
daemon_churn's load (they retry through it, each retry explained
inline). Each drill line carries the process's thread switch interval;
`python3 -c "import sys; sys.setswitchinterval(S); import chip_smoke;
chip_smoke.main(['--daemon'])"` runs it at another.
"""

from __future__ import annotations

import argparse
import functools
import gc
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import threading
import time

REPO = os.path.dirname(os.path.abspath(__file__))

N_PODS, N_NODES = 50000, 5000
MAIN_REPEATS = 2  # timed runs after a warm-up (3 before PR 17's cut)
PLAIN_BUDGET_S = 60.0  # the plain loop over the whole backlog, else one chunk
KERNEL_REPEATS = 3  # 5 before PR 17's cut
CHURN_RATE, CHURN_WARMUP, CHURN_TICKS = 1000, 2, 10
CHURN_CHECKED = (1, 5, 10)  # timed ticks whose kernel runs are held to the plain version
GANG_SIZE = 50
POLICY_REPEATS = 2  # 3 before PR 17's cut
POLICY_CHECKED = 4096  # pods of the 50k policy backlog held to the plain version
EXPLAIN_PODS = 1024
SIDECAR_WAIT_S = 120

# The card's published rates (NVIDIA H100 SXM data sheet): HBM bytes/s and
# f32 operations/s outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12


_T0 = time.perf_counter()


def emit(phase: str, **fields) -> None:
    """One phase's JSON line, with the script's seconds so far."""
    print(json.dumps({"phase": phase, **fields, "elapsed_s": time.perf_counter() - _T0}), flush=True)


def fail(phase: str, message: str) -> None:
    """The phase's failure line, on stdout and, so that the end of the
    error stream names it too, on stderr; then the check pool is
    stopped and the script exits 1."""
    emit(phase, ok=False, error=message)
    print(f"chip_smoke: phase {phase} failed: {message}", file=sys.stderr, flush=True)
    stop_cpu_checks()
    sys.exit(1)


CPU_CHECK_WORKERS = 5  # child processes for the NumPy checks (the host has 8 cores)
_CPU_POOL = []


def _timed_call(fn, *args):
    """(fn(*args), seconds): what a check's child returns."""
    t0 = time.perf_counter()
    out = fn(*args)
    return out, time.perf_counter() - t0


def cpu_check(fn, *args):
    """Start `fn(*args)`, a NumPy check that touches no card, in a child
    process (spawned, never forked from this CUDA process) and return
    its future, whose result is (value, seconds). The checks of the
    defrag plan and of the windowed solvers' quality run there while
    this process goes on with untimed work: the defrag plan's K2 outputs
    are read beside its twins and K2 is timed after they end; the
    windowed solvers' quality checks run beside each other, Sinkhorn's
    warm-up and both modes' card-against-CPU cases, whose host times
    (that warm-up's `wall_s`, `card_s`, `cpu_s`) are kept only as a
    reading.
    The pool ends with `main`."""
    if not _CPU_POOL:
        import concurrent.futures
        import multiprocessing

        _CPU_POOL.append(concurrent.futures.ProcessPoolExecutor(
            max_workers=CPU_CHECK_WORKERS, mp_context=multiprocessing.get_context("spawn")))
    return _CPU_POOL[0].submit(_timed_call, fn, *args)


def stop_cpu_checks():
    while _CPU_POOL:
        _CPU_POOL.pop().shutdown(wait=True, cancel_futures=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--host-timing", action="store_true",
                        help="time the host work around the card only")
    parser.add_argument("--root", default=REPO, help="checkout to import the port from")
    parser.add_argument("--runs", type=int, default=MAIN_REPEATS)
    parser.add_argument("--daemon", action="store_true",
                        help="build, then run only phase 5o (the scheduler daemon)")
    parser.add_argument("--mesh", action="store_true",
                        help="build, then run only phase 5p (the node-sharded mesh)")
    parser.add_argument("--daemon-legs", default="",
                        help="with --daemon: the comma-separated legs of phase 5o to run "
                             "(default all)")
    parser.add_argument("--soak-epochs", default="",
                        help="the soak leg's epochs, comma-separated, or `all` for the full "
                             "schedule (default: SOAK_EPOCHS)")
    parser.add_argument("--churn-stuck", type=int, default=0,
                        help="pods that fit no node, created before daemon_churn's load "
                             "(default 0)")
    args = parser.parse_args(argv)
    if args.host_timing:
        return host_timing(os.path.abspath(args.root), args.runs)
    sys.path.insert(0, REPO)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; nothing run", file=sys.stderr)
        return 2
    try:
        from kubernetes_tpu_torch.ops import build  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the port is not importable here: {e}", file=sys.stderr)
        return 3

    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    kind = torch.cuda.get_device_name(0)

    # -- 1. device ---------------------------------------------------------
    smi = nvidia_smi_line()
    print(smi, flush=True)
    emit(
        "device", ok=True, kind=kind, count=torch.cuda.device_count(),
        nvidia_smi=smi, torch=torch.__version__, cuda=torch.version.cuda,
        python=sys.version.split()[0],
    )

    # -- 2. build ----------------------------------------------------------
    t0 = time.perf_counter()
    records = build.build_all()
    emit(
        "build", ok=True, seconds=time.perf_counter() - t0,
        kernels=[
            {"name": r["name"], "tool": r["tool"], "seconds": r["seconds"], "built": r["built"],
             "ptxas": [l for l in str(r["log"]).splitlines() if "ptxas" in l][-4:]}
            for r in records
        ],
    )

    if args.mesh:
        mesh = run_mesh(torch, device, smi)
        emit("mesh", ok=True, card=smi, **mesh)
        print(json.dumps({"kernels": [mesh_kernel_line(mesh)]}), flush=True)
        print(smi, flush=True)
        return 0
    if args.daemon:
        run_daemon(torch, device, smi, legs=set(filter(None, args.daemon_legs.split(","))),
                   churn_stuck=args.churn_stuck, soak_epochs=args.soak_epochs)
        print(smi, flush=True)
        return 0

    # -- 3. parity ---------------------------------------------------------
    parity = check_parity(torch, device)
    emit("parity", ok=True, **parity["summary"])

    # -- 4. repeat ----------------------------------------------------------
    emit("repeat", ok=True, **check_repeat(torch, parity["chunk_state"], parity["chunk_result"]))
    parity_in_place = check_parity_in_place(torch, device, parity["chunk_state"])
    emit("parity_in_place", ok=True, **parity_in_place)

    # -- 5. main path ------------------------------------------------------
    main_result = run_main_path(torch, device, parity["reference"])
    placed_names = main_result.pop("first_names")
    emit("main", ok=True, card=smi, **main_result)

    # -- 5a. the host lowering helper ----------------------------------------
    emit("native", ok=True, card=smi, **run_native(records, placed_names))

    # -- 5b. churn on the incremental session ------------------------------
    churn = run_churn(torch, device, placed_names)
    churn_session = churn.pop("session")
    emit("churn", ok=True, card=smi, **churn)

    # -- 5c. gangs -----------------------------------------------------------
    gang = run_gang(torch, device)
    emit("gang", ok=True, **gang)

    # -- 5d-5g. policy specs, explain, the sidecar ---------------------------
    policy_parity = check_policy_parity(torch, device)
    emit("policy_parity", ok=True, **policy_parity)
    policy = run_policy(torch, device)
    policy_names = policy.pop("names")
    policy_timing = policy.pop("timing")
    policy_sweep_state = policy.pop("sweep_state")
    emit("policy", ok=True, card=smi, **policy)
    emit("explain", ok=True, card=smi, **run_explain(torch, device))
    # -- 5h-5i. the windowed solvers -------------------------------------------
    scan_placed = sum(n is not None for n in placed_names)
    windowed = start_windowed(torch, device, ("wave", "sinkhorn"), scan_placed)
    for mode, started in windowed.items():
        emit(mode, ok=True, card=smi, **run_windowed(torch, device, mode, placed_names, started))
    sidecar_line = run_sidecar(torch, device, placed_names, policy_names)
    emit("sidecar", ok=True, card=smi, **sidecar_line)

    # -- 5j-5m. preemption, the capacity report, the defrag plan ----------------
    from kubernetes_tpu_torch.ops import rebalance

    # K2 is not on these two paths: their counts are read to show it.
    k2_launches = {}
    rebalance.plan_moves.launches = 0
    emit("preemption", ok=True, card=smi, **run_preemption(torch, device))
    k2_launches["preemption"] = rebalance.plan_moves.launches
    rebalance.plan_moves.launches = 0
    emit("capacity", ok=True, card=smi, **run_capacity(torch, device, placed_names, churn_session))
    k2_launches["capacity"] = rebalance.plan_moves.launches
    del churn_session
    rebalance_parity = check_rebalance_parity(torch, device)
    emit("rebalance_parity", ok=True, **rebalance_parity)
    rebalance_line = run_rebalance(torch, device, placed_names)
    emit("rebalance", ok=True, card=smi, **rebalance_line)

    # -- 5n. the telemetry plane -------------------------------------------------
    emit("telemetry", ok=True, card=smi, **run_telemetry(torch, device, main_result, churn,
                                                         placed_names))

    # -- 5p. the node-sharded mesh ------------------------------------------------
    mesh = run_mesh(torch, device, smi)
    emit("mesh", ok=True, card=smi, **mesh)

    # -- 5o. the scheduler daemon against the port's apiserver --------------------
    daemon = run_daemon(torch, device, smi, soak_epochs=args.soak_epochs)

    # -- 6. kernels --------------------------------------------------------
    ptxas = "\n".join(str(r["log"]) for r in records if r["name"] == "scan_kernel")
    timing = time_kernel(torch, device, parity["chunk_state"], parity["chunk_result"], ptxas)
    policy_sweep = time_policy_kernel(torch, policy_sweep_state)
    kernels = [
        {
            "name": "scan_kernel",
            "route": "cuda",
            "source": "kubernetes_tpu_torch/csrc/scan_kernel.cu",
            "replaces": "kubernetes_tpu/ops/pallas_scan.py:126",
            "launches": main_result["launches_last_run"],
            "launches_by_path": {
                "main": main_result["launches_last_run"],
                "churn": churn["launches"],
                "churn_pipelined": churn["pipelined"]["launches"],
                "gang_50k": gang["backlog"]["launches"],
                "sidecar_default": sidecar_line["default"]["kernel_launches"]["scan_kernel"],
                "parity_in_place": parity_in_place["launches"],
                "daemon_parity": daemon["daemon_parity"]["launches"],
                "daemon_parity_wide": daemon["daemon_parity_wide"]["launches"],
                "daemon_drill": daemon["daemon_drill"]["wrapper_launches"],
                "daemon_churn": daemon["daemon_churn"]["wrapper_launches"],
                "daemon_parity_hostnames": daemon["daemon_parity_hostnames"]["launches"],
                "daemon_sidecar_parity": daemon["daemon_sidecar_parity"]["launches"],
                "desched_defrag": daemon["desched_defrag"]["k1_launches"],
                "autoscale_cycle": daemon["autoscale_cycle"]["k1_launches"],
                # The command's own process, read from its /debug/kernels.
                "daemon_debug": daemon["daemon_debug"]["k1_launches"],
                # The warm standbys' prewarms and the activated daemons' ticks.
                "daemon_failover": daemon["daemon_failover"]["k1_launches"],
                "daemon_ha": daemon["daemon_ha"]["k1_launches"],
                # The rival command's own process (prewarm and ticks).
                "daemon_ha_cmd": daemon["daemon_ha_cmd"]["k1_launches_b"],
                # The per-pod daemon runs no kernel.
                "daemon_scalar": daemon["daemon_scalar"]["k1_launches"],
                "apiserver_durable": daemon["apiserver_durable"]["k1_launches"],
                "apiserver_replicated": daemon["apiserver_replicated"]["k1_launches"],
                # The started daemon's ticks under the controller-manager.
                "controller_rc": daemon["controller_rc"]["k1_launches"],
                "controller_node_loss": daemon["controller_node_loss"]["k1_launches"],
                # The started daemon's ticks under the port's kubelets.
                "kubelet_density": daemon["kubelet_density"]["k1_launches"],
                "kubelet_service": daemon["kubelet_service"]["k1_launches"],
                # The local-up-cluster child's own process, past its prewarm.
                "local_up": daemon["local_up"]["k1_launches"],
                # The same, driven by the port's CLI.
                "ktctl": daemon["ktctl"]["k1_launches"],
                # The soak's daemons (the killed ones, the fresh ones and
                # the warm standby) under its fault schedule.
                "soak": daemon["soak"]["k1_launches"],
            },
            "max_abs_err": max(parity["summary"]["max_abs_err"], parity_in_place["max_abs_err"]),
            "ms": timing["ms"],
            "plain_ms": parity["plain_ms"],
            "bound_ms": timing["bound_ms"],
            "bound_by": timing["bound_by"],
            # No single PyTorch call computes the sequential solve.
            "library_ms": None,
            "session_shape": churn["kernel_at_session_shape"],
        },
        {
            "name": "policy_scan_kernel",
            "route": "cuda",
            "source": "kubernetes_tpu_torch/csrc/policy_scan_kernel.cu",
            # An XLA function of the JAX package, not a Pallas kernel.
            "replaces": "kubernetes_tpu/ops/solver.py:304 (_scan_solve under _solve_xla, "
                        "policy LoweredSpec; XLA, not a Pallas kernel)",
            "launches": policy["launches_last_run"],
            "launches_by_path": {
                "policy": policy["launches_last_run"],
                "sidecar_policy": sidecar_line["policy"]["kernel_launches"]["policy_scan_kernel"],
                "policy_past_8": policy_parity["past_8"]["launches"],
                "daemon_policy_parity": daemon["daemon_policy_parity"]["launches"],
                "daemon_policy_drill": daemon["daemon_policy_drill"]["wrapper_launches"],
            },
            "max_abs_err": max(policy_parity["max_abs_err"], policy_timing["max_abs_err"]),
            "ms": policy_timing["ms"],
            "plain_ms": policy_timing["plain_ms"],
            "bound_ms": policy_timing["bound_ms"],
            "bound_by": policy_timing["bound_by"],
            # No single PyTorch call computes the sequential solve.
            "library_ms": None,
            "timed": policy_timing["timed"],
            "backlog_ms": policy["kernel_ms"],
            "cluster": policy["plan"]["cluster"],
        },
        {
            "name": "rebalance_kernel",
            "route": "cuda",
            "source": "kubernetes_tpu_torch/csrc/rebalance_kernel.cu",
            "replaces": "kubernetes_tpu/ops/rebalance.py:58 (plan_moves; XLA, not a Pallas kernel)",
            "launches": sum(rebalance_line["launches"].values()),
            "launches_by_path": {**{f"rebalance_{k}": v for k, v in rebalance_line["launches"].items()},
                                 **k2_launches, "rebalance_parity": rebalance_parity["launches"],
                                 "desched_defrag": daemon["desched_defrag"]["k2_launches"],
                                 "autoscale_cycle": daemon["autoscale_cycle"]["k2_launches"],
                                 "soak": daemon["soak"]["k2_launches"]},
            "max_abs_err": max(rebalance_parity["max_abs_err"], rebalance_line["k2"]["max_abs_err"]),
            # ms, plain_ms and bound_ms: the same first rows of case budget_d.
            "ms": rebalance_line["k2"]["ms"],
            "plain_ms": rebalance_line["k2"]["plain_ms"],
            "bound_ms": rebalance_line["k2"]["bound_ms"],
            "bound_by": rebalance_line["k2"]["bound_by"],
            # No single PyTorch call computes the sequential plan.
            "library_ms": None,
            "rows": rebalance_line["k2"]["rows"],
            "worklist_ms": rebalance_line["k2"]["worklist_ms"],
            "worklist_bound_ms": rebalance_line["k2"]["worklist"]["bound_ms"],
            "us_per_row": rebalance_line["k2"]["us_per_row"],
            "worklists": rebalance_line["k2"]["worklists"],
            "plan": rebalance_line["k2"]["plan"],
        },
        mesh_kernel_line(mesh),
    ]
    emit("kernel_timing", ok=True, card=smi, **timing, policy_sweep=policy_sweep)
    stop_cpu_checks()
    jax_package = sorted(m for m in sys.modules if m == "kubernetes_tpu" or m.startswith("kubernetes_tpu."))
    if jax_package:
        fail("end", f"modules of the JAX package were loaded: {jax_package[:5]}")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()},
    }), flush=True)
    return 0


# ---------------------------------------------------------------------------
# Host timing, shared by the phases and by --host-timing
# ---------------------------------------------------------------------------

_SWEEP = ("greedy_fit", "or_rows_by_index")


class GcPauses:
    """Python's garbage-collector passes while in the block, by
    generation, with their wall seconds (a pause lands in whichever
    phase it falls into)."""

    def __init__(self):
        self.pauses, self._t0 = [], 0.0

    def _on_gc(self, stage, info):
        if stage == "start":
            self._t0 = time.perf_counter()
        else:
            self.pauses.append((info["generation"], time.perf_counter() - self._t0))

    def __enter__(self):
        gc.callbacks.append(self._on_gc)
        return self

    def __exit__(self, *exc):
        gc.callbacks.remove(self._on_gc)

    def summary(self):
        return {
            "passes": len(self.pauses),
            "gen2_passes": sum(g == 2 for g, _ in self.pauses),
            "total_s": sum(t for _, t in self.pauses),
            "max_s": max((t for _, t in self.pauses), default=0.0),
        }


def lower_split(pending, nodes, assigned=(), services=(), spec=None, repeats=3) -> dict:
    """The columnar lowering's steps timed one after another on the host
    clock with the garbage collector off: `vocabularies` (the
    SnapshotBuilder's construction: the vocabulary passes and the
    selector table), `pod_columns` (the whole backlog in one call),
    `node_columns` (with `assigned_sweep`, the seconds inside its
    greedy_fit and or_rows_by_index calls, and `assigned_pack`, inside
    its pack_bitsets calls), `service_seeds` (policy specs with service
    affinity or anti-affinity only), and `rest`: a whole `build_snapshot`
    on the same objects less those steps. Each is the least of `repeats`
    rounds, after one untimed `build_snapshot` (first-use costs: loading
    the helper). `gc_pass_s` is one full collector pass after a round,
    with the lowered objects alive: what a pass that lands in a lowering
    costs at this heap. Works on any checkout: the helpers are timed
    where its lowering calls them (the native module, or the columnar
    module's own NumPy functions)."""
    from kubernetes_tpu_torch.models import columnar

    holder = getattr(columnar, "native", columnar)
    names = _SWEEP + ("pack_bitsets",)
    saved = {name: getattr(holder, name) for name in names}
    columnar.build_snapshot(pending, nodes, assigned, services, spec=spec)
    rounds = []
    for _ in range(repeats):
        out, inside = {}, {name: 0.0 for name in names}

        def timed(name, fn):
            def call(*args, **kwargs):
                t = time.perf_counter()
                try:
                    return fn(*args, **kwargs)
                finally:
                    inside[name] += time.perf_counter() - t
            return call

        gc.collect()
        gc.disable()
        try:
            t0 = time.perf_counter()
            builder = columnar.SnapshotBuilder(pending, nodes, assigned, services, spec=spec)
            out["vocabularies_s"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            builder.pod_columns()
            out["pod_columns_s"] = time.perf_counter() - t0
            for name, fn in saved.items():
                setattr(holder, name, timed(name, fn))
            try:
                t0 = time.perf_counter()
                builder.node_columns()
                out["node_columns_s"] = time.perf_counter() - t0
            finally:
                for name, fn in saved.items():
                    setattr(holder, name, fn)
            out["assigned_sweep_s"] = sum(inside[n] for n in _SWEEP)
            out["assigned_pack_s"] = inside["pack_bitsets"]
            out["service_seeds_s"] = 0.0
            lowered = getattr(builder, "_lowered_partial", None)
            if spec is not None and lowered is not None and (
                    lowered.service_affinity or lowered.aa_weights):
                t0 = time.perf_counter()
                builder._service_seeds()
                out["service_seeds_s"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            snap = columnar.build_snapshot(pending, nodes, assigned, services, spec=spec)
            out["build_snapshot_s"] = time.perf_counter() - t0
        finally:
            gc.enable()
        t0 = time.perf_counter()
        gc.collect()
        out["gc_pass_s"] = time.perf_counter() - t0
        del builder, snap
        rounds.append(out)
    best = {k: min(r[k] for r in rounds) for k in rounds[0]}
    steps = ("vocabularies_s", "pod_columns_s", "node_columns_s", "service_seeds_s")
    best["rest_s"] = best["build_snapshot_s"] - sum(best[k] for k in steps)
    best["native"] = holder is not columnar
    return best


def time_backlog(torch, device, runs, check=None, gc_off=False):
    """solve_backlog_pipelined on synthetic_objects(N_PODS, N_NODES,
    seed=2+r): a warm-up and `runs` timed runs, each with its wall,
    phases, scan kernel launches, pods placed and the collector's passes
    (`gc_off`: the collector disabled around the call). `check(r, names,
    launches)` runs after each run and returns more fields for its
    record. Returns (records, the warm-up's names)."""
    from kubernetes_tpu_torch import workload
    from kubernetes_tpu_torch.ops import scan_kernel
    from kubernetes_tpu_torch.ops.pipeline import solve_backlog_pipelined
    from kubernetes_tpu_torch.utils.tracing import PhaseTimer

    records, first = [], None
    for r in range(runs + 1):
        pending, nodes, services = workload.synthetic_objects(N_PODS, N_NODES, seed=2 + r)
        timer = PhaseTimer()
        torch.cuda.synchronize()
        scan_kernel.scan_with_state.launches = 0
        with _collector(gc_off) as pauses:
            t0 = time.perf_counter()
            names = solve_backlog_pipelined(pending, nodes, services=services, device=device,
                                            timer=timer)
            wall = time.perf_counter() - t0
        launches = scan_kernel.scan_with_state.launches
        first = names if r == 0 else first
        records.append({"run": "warmup" if r == 0 else f"timed{r}", "seed": 2 + r,
                        "wall_s": wall, "placed": sum(n is not None for n in names),
                        "pods_per_s": N_PODS / wall, "launches": launches,
                        "phases_s": timer.seconds, "gc": pauses.summary(),
                        **(check(r, names, launches) if check else {})})
    return records, first


def time_policy(torch, device, runs, check=None, gc_off=False):
    """schedule_backlog(spec=FULL_VOCABULARY_POLICY) on
    policy_objects(N_PODS, N_NODES, seed=2): a warm-up and `runs` timed
    runs, each with its wall, phases, policy kernel launches, pods
    placed and the collector's passes (`gc_off` as in time_backlog).
    `check(r, names, launches)` as in time_backlog. Returns (records,
    the warm-up's names, the objects, the spec, the objects' seconds)."""
    from kubernetes_tpu_torch import workload
    from kubernetes_tpu_torch.models.algspec import spec_from_policy
    from kubernetes_tpu_torch.ops import policy_scan
    from kubernetes_tpu_torch.scheduler.batch import schedule_backlog
    from kubernetes_tpu_torch.utils.tracing import PhaseTimer

    spec = spec_from_policy(workload.FULL_VOCABULARY_POLICY)
    t0 = time.perf_counter()
    objs = workload.policy_objects(N_PODS, N_NODES, seed=2)
    objects_s = time.perf_counter() - t0
    records, first = [], None
    for r in range(runs + 1):
        timer = PhaseTimer()
        torch.cuda.synchronize()
        policy_scan.policy_scan_with_state.launches = 0
        with _collector(gc_off) as pauses:
            t0 = time.perf_counter()
            names = schedule_backlog(*objs, device=device, timer=timer, spec=spec)
            wall = time.perf_counter() - t0
        launches = policy_scan.policy_scan_with_state.launches
        first = names if r == 0 else first
        records.append({"run": "warmup" if r == 0 else f"timed{r}", "wall_s": wall,
                        "placed": sum(n is not None for n in names), "launches": launches,
                        "phases_s": timer.seconds, "gc": pauses.summary(),
                        **(check(r, names, launches) if check else {})})
    return records, first, objs, spec, objects_s


class _collector(GcPauses):
    """GcPauses, with the collector disabled in the block when `off`."""

    def __init__(self, off):
        super().__init__()
        self._off = off

    def __enter__(self):
        if self._off:
            gc.disable()
        return super().__enter__()

    def __exit__(self, *exc):
        super().__exit__(*exc)
        if self._off:
            gc.enable()


def wall_stats(records):
    """Median wall of the timed records, and of the walls less their
    collector passes."""
    timed = records[1:]
    return {"wall_s_median": statistics.median(r["wall_s"] for r in timed),
            "wall_less_gc_s_median": statistics.median(r["wall_s"] - r["gc"]["total_s"]
                                                       for r in timed)}


def _churn_cluster(placed_names):
    """The 50k x 5k backlog's nodes and services, and its pods as the
    first main run placed them, bound and Running (unplaced ones left
    out)."""
    from kubernetes_tpu_torch import workload

    pods, nodes, services = workload.synthetic_objects(N_PODS, N_NODES, seed=2)
    assigned = []
    for pod, name in zip(pods, placed_names):
        if name is not None:
            pod.spec.node_name = name
            pod.status.phase = "Running"
            assigned.append(pod)
    return nodes, services, assigned


def _replay(services, assigned):
    """workload.churn_replay's arguments for BASELINE config 5 on the
    churn cluster."""
    return dict(live=[f"default/{p.metadata.name}" for p in assigned],
                ticks=CHURN_WARMUP + CHURN_TICKS, rate=CHURN_RATE, seed=7,
                n_services=len(services), first_index=N_PODS)


def tick_stats(timed):
    """The timed ticks' wall p50 and p99, and each phase's median and p99."""
    walls = [r.wall_s for r in timed]
    phases = sorted({p for r in timed for p in r.phases_s})
    return {
        "tick_p50_s": _percentile(walls, 50), "tick_p99_s": _percentile(walls, 99),
        "phase_median_s": {p: statistics.median(r.phases_s.get(p, 0.0) for r in timed)
                           for p in phases},
        "phase_p99_s": {p: _percentile([r.phases_s.get(p, 0.0) for r in timed], 99)
                        for p in phases},
    }


def host_timing(root, runs) -> int:
    """--host-timing: the host work around the card of the package in
    `root`, one JSON line a measurement, each with the card's name and
    power limit: the backlog and the policy backlog (time_backlog and
    time_policy, `runs` timed runs with the collector on, then with it
    off), `lower_split` of the default backlog, the policy backlog and
    the churn cluster's assigned pods alone, and the churn ticks' phases
    (BASELINE config 5, as phase 5b's synchronous run). Host times vary
    between calls, so two checkouts are compared by running this in turns
    in one command (A B B A)."""
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; nothing run", file=sys.stderr)
        return 2
    import kubernetes_tpu_torch
    from kubernetes_tpu_torch import workload

    if not os.path.abspath(kubernetes_tpu_torch.__file__).startswith(root + os.sep):
        print(f"chip_smoke: imported {kubernetes_tpu_torch.__file__}, not from {root}",
              file=sys.stderr)
        return 3
    device = torch.device("cuda", 0)
    smi = nvidia_smi_line()

    def out(what, **fields):
        print(json.dumps({"root": root, "what": what, "card": smi, **fields}), flush=True)

    first = None
    for gc_off in (False, True):
        records, names = time_backlog(torch, device, runs, gc_off=gc_off)
        first = first or names
        out("backlog", gc_off=gc_off, **wall_stats(records), runs=records)
    for gc_off in (False, True):
        records, _names, objs, spec, _ = time_policy(torch, device, runs, gc_off=gc_off)
        out("policy", gc_off=gc_off, **wall_stats(records), runs=records)
    pending, nodes, services = workload.synthetic_objects(N_PODS, N_NODES, seed=2)
    out("lower", cell="main", **lower_split(pending, nodes, (), services))
    out("lower", cell="policy", **lower_split(*objs, spec))
    cnodes, cservices, cassigned = _churn_cluster(first)
    out("lower", cell="assigned", assigned=len(cassigned),
        **lower_split([], cnodes, cassigned, cservices))
    session, build_s, _, _ = _new_session(torch, device, cnodes, cservices, cassigned)
    records = workload.churn_replay(session, **_replay(cservices, cassigned))
    out("churn", session_build_s=build_s, **tick_stats(records[CHURN_WARMUP:]),
        delete_s=[r.phases_s.get("delete", 0.0) for r in records[CHURN_WARMUP:]])
    return 0


# ---------------------------------------------------------------------------
# Phase 3: kernel vs plain
# ---------------------------------------------------------------------------


def _copy(d):
    return {k: v.clone() for k, v in d.items()}


def _max_abs_err(torch, a, b) -> float:
    if a.numel() == 0:
        return 0.0
    return float((a.to(torch.float64) - b.to(torch.float64)).abs().max().item())


def _compare(torch, tag, got_choice, got_nodes, ref_choice, ref_nodes, phase="parity") -> float:
    """The largest absolute difference over the decisions and the nine
    carry fields, and the service carry where there is one (bitset words
    compared as int32, exactly). The tolerance is exact equality: any
    difference fails the phase."""
    from kubernetes_tpu_torch.ops.matrices import CARRY_KEYS, POLICY_CARRY_KEYS

    err = _max_abs_err(torch, got_choice, ref_choice)
    if not torch.equal(got_choice, ref_choice):
        bad = int((got_choice != ref_choice).sum().item())
        first = int((got_choice != ref_choice).nonzero()[0].item())
        fail(phase, f"{tag}: {bad} decisions differ, first at pod {first}")
    for k in CARRY_KEYS + tuple(k for k in POLICY_CARRY_KEYS if k in ref_nodes):
        field_err = _max_abs_err(torch, got_nodes[k], ref_nodes[k])
        if not torch.equal(got_nodes[k], ref_nodes[k]):
            fail(phase, f"{tag}: carry field {k} differs (max abs err {field_err})")
        err = max(err, field_err)
    return err


def _kernel_vs_plain(torch, tag, pods, nodes, weights):
    from kubernetes_tpu_torch.ops import scan_kernel

    kn, pn = _copy(nodes), _copy(nodes)
    got, kn = scan_kernel.scan_with_state(pods, kn, weights)
    ref, pn = scan_kernel.plain_scan_with_state(pods, pn, weights)
    torch.cuda.synchronize()
    return _compare(torch, tag, got, kn, ref, pn)


def _multiword_cluster():
    from kubernetes_tpu_torch.models.objects import (
        Container, ContainerPort, Node, NodeCondition, NodeStatus, ObjectMeta,
        Pod, PodSpec, ResourceRequirements,
    )
    from kubernetes_tpu_torch.models.quantity import Quantity, parse_quantity

    nodes = [
        Node(
            metadata=ObjectMeta(name=f"n{j}"),
            status=NodeStatus(
                capacity={"cpu": Quantity.from_milli(4000),
                          "memory": parse_quantity("4096Mi"),
                          "pods": Quantity.from_int(200)},
                conditions=[NodeCondition(type="Ready", status="True")],
            ),
        )
        for j in range(4)
    ]

    def pod(name, port):
        return Pod(
            metadata=ObjectMeta(name=name, namespace="default"),
            spec=PodSpec(containers=[Container(
                name="c", ports=[ContainerPort(container_port=80, host_port=port)],
                resources=ResourceRequirements(limits={
                    "cpu": Quantity.from_milli(10), "memory": parse_quantity("8Mi")}),
            )]),
        )

    # 70 distinct host ports need 3 u32 words (bucketed to 4); the second
    # round reuses the first ports and must avoid their nodes.
    pods = [pod(f"p{i}", 7000 + i) for i in range(70)]
    pods += [pod(f"q{i}", 7000 + i) for i in range(8)]
    return pods, nodes


def check_parity(torch, device):
    from kubernetes_tpu_torch import workload
    from kubernetes_tpu_torch.models.columnar import SnapshotBuilder, build_snapshot
    from kubernetes_tpu_torch.ops import scan_kernel
    from kubernetes_tpu_torch.ops.matrices import device_nodes, device_pods, device_snapshot
    from kubernetes_tpu_torch.ops.pipeline import DEFAULT_CHUNK

    cases = 0
    max_err = 0.0
    for seed in range(12):
        pending, nodes, assigned, services = workload.small_cluster(seed)
        d = device_snapshot(build_snapshot(pending, nodes, assigned, services), device)
        for weights in ((1, 1, 1), (2, 0, 3), (0, 5, 1)):
            max_err = max(max_err, _kernel_vs_plain(
                torch, f"small seed {seed} weights {weights}", d.pods, d.nodes, weights))
            cases += 1
    for seed in range(3):
        # A service id listed twice in a pod's row commits twice.
        pending, nodes, assigned, services = workload.small_cluster(seed)
        d = device_snapshot(build_snapshot(pending, nodes, assigned, services), device)
        ids = d.pods["svc_ids"]
        ids[:, 1] = torch.where(ids[:, 0] >= 0, ids[:, 0], ids[:, 1])
        max_err = max(max_err, _kernel_vs_plain(
            torch, f"repeated service ids, seed {seed}", d.pods, d.nodes, (1, 1, 1)))
        cases += 1
    pods, nodes = _multiword_cluster()
    d = device_snapshot(build_snapshot(pods, nodes), device)
    max_err = max(max_err, _kernel_vs_plain(torch, "multi-word bitsets", d.pods, d.nodes, (1, 1, 1)))
    cases += 1

    # The scan cluster's edges, on node axes left unpadded (pad_to=1): a
    # last CTA with a short slice (5,121 nodes over 16 CTAs of 324),
    # CTAs with no node (7 nodes), crowded services whose max count the
    # commits keep raising (6 nodes), and unplaceable pods (pinned to -2
    # or past the node axis) between placed ones. Nodes of nine kinds
    # give equal best scores in several CTAs.
    edges = (
        ("5,121 nodes", 2048, 5121, 7),
        ("7 nodes, fewer than the CTAs", 300, 7, 8),
        ("crowded services on 6 nodes", 400, 6, 9),
        ("unplaceable pods between placed ones", 600, 200, 10),
    )
    for tag, n_pods, n_nodes, seed in edges:
        pending, nodes, services = workload.synthetic_objects(n_pods, n_nodes, seed=seed)
        d = device_snapshot(build_snapshot(pending, nodes, services=services), device, 1)
        if tag.startswith("unplaceable"):
            d.pods["pinned"][1::3] = -2
            d.pods["pinned"][2::7] = n_nodes + 3
        max_err = max(max_err, _kernel_vs_plain(torch, tag, d.pods, d.nodes, (1, 1, 1)))
        cases += 1

    # The main path's state: the 50k x 5k backlog of the first main run,
    # lowered and staged exactly as solve_backlog_pipelined does.
    pending, nodes, services = workload.synthetic_objects(N_PODS, N_NODES, seed=2)
    builder = SnapshotBuilder(pending, nodes, (), services)
    carry_k = device_nodes(builder.node_columns(), device)
    carry_p = _copy(carry_k)
    starts = list(range(0, N_PODS, DEFAULT_CHUNK))
    reference = []  # plain decisions of the checked pods, in order
    chunk_state = None
    plain_s = 0.0
    plain_ms = None
    chunks_checked = 0
    for ci, start in enumerate(starts):
        cols = builder.pod_columns(start, min(start + DEFAULT_CHUNK, N_PODS))
        dpods = device_pods(cols, device)
        if ci == 0:
            chunk_state = (dpods, _copy(carry_k))
        got, carry_k = scan_kernel.scan_with_state(dpods, carry_k)
        if ci == 0:
            chunk_result = (got.clone(), _copy(carry_k))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ev0, ev1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        ev0.record()
        ref, carry_p = scan_kernel.plain_scan_with_state(dpods, carry_p, (1, 1, 1))
        ev1.record()
        torch.cuda.synchronize()
        plain_s += time.perf_counter() - t0
        if ci == 0:
            plain_ms = ev0.elapsed_time(ev1)
        max_err = max(max_err, _compare(torch, f"50k x 5k chunk {ci}", got, carry_k, ref, carry_p))
        reference.extend(ref[: cols.count].tolist())
        chunks_checked += 1
        remaining = len(starts) - ci - 1
        if remaining and plain_s / (ci + 1) * remaining > PLAIN_BUDGET_S:
            break
    checked = len(reference)
    scope = "full" if checked == N_PODS else "first_chunk"
    names = [n.metadata.name for n in nodes]
    return {
        "summary": {
            "cases": cases,
            "backlog_scope": scope,
            "backlog_pods_checked": checked,
            "backlog_chunks_checked": chunks_checked,
            "plain_seconds": plain_s,
            "max_abs_err": max_err,
            "tolerance": "exact (torch.equal)",
        },
        "reference": [names[j] if j >= 0 else None for j in reference],
        "chunk_state": chunk_state,
        "chunk_result": chunk_result,
        "plain_ms": plain_ms,
    }


# ---------------------------------------------------------------------------
# Phase 4: repeated runs
# ---------------------------------------------------------------------------


def check_repeat(torch, chunk_state, chunk_result, runs=5):
    """The scan kernel `runs` times on the first 50k x 5k chunk, each run
    from the same carry: decisions and carry must equal the checked
    result every time. The CPU emulation's barriers are sequentially
    consistent, so a missing fence or a stale cache line between the
    cluster's CTAs can only show here."""
    from kubernetes_tpu_torch.ops import scan_kernel

    pods, carry0 = chunk_state
    ref, ref_nodes = chunk_result
    for i in range(runs):
        nodes = _copy(carry0)
        got, nodes = scan_kernel.scan_with_state(pods, nodes)
        torch.cuda.synchronize()
        _compare(torch, f"repeat {i} of the first chunk", got, nodes, ref, ref_nodes)
    return {"runs": runs, "pods": int(pods["cpu"].shape[0]), "identical": True}


# ---------------------------------------------------------------------------
# Phase 4b: the scan kernel in place
# ---------------------------------------------------------------------------

IN_PLACE_PODS = 1024  # the prefix of each backlog held to the plain version in place
IN_PLACE_NODES = 50000  # a node axis past the 40,384 a cluster holds resident
SESSION_IN_PLACE_NODES = 30000  # past the 27,840 at the session's 4-word widths


def _widen(torch, pods, nodes, words):
    """The bitset columns zero-padded to `words` words: the widths of the
    session, which take the kernel's runtime-width instance."""
    def pad(t):
        return torch.cat([t, t.new_zeros(t.shape[0], words - t.shape[1])], 1).contiguous()

    return ({k: pad(v) if k in ("sel", "port", "vol_any", "vol_rw") else v for k, v in pods.items()},
            {k: pad(v) if k in ("labels", "uport", "uvol_any", "uvol_rw") else v
             for k, v in nodes.items()})


def check_parity_in_place(torch, device, chunk_state):
    """The scan kernel with its slices in device memory, held exactly to
    the plain version: small clusters forced in place on 1, 4 and 16
    CTAs; the main backlog's first 1,024 pods on its 5,120 nodes forced
    in place, twice; 1,024 pods on 50,000 nodes, where the default plan
    is in place; and the runtime-width instance (4-word bitsets) on
    30,000 nodes, past the session's resident limit. Then every pod tile
    the plan can pick (128 pods down to 8, and rows read in place),
    resident and in place, on 300 pods of ties over 45 nodes (4-word
    bitsets), and rows of 348 and 3,720 words at their own tiles."""
    from kubernetes_tpu_torch import workload
    from kubernetes_tpu_torch.models.columnar import build_snapshot
    from kubernetes_tpu_torch.ops import scan_kernel
    from kubernetes_tpu_torch.ops.matrices import device_snapshot

    scan_kernel.scan_with_state.launches = 0
    cases, max_err, plans = 0, 0.0, []

    def held(tag, pods, nodes, plan, timed=False):
        nonlocal cases, max_err
        if plan.resident:
            fail("parity_in_place", f"{tag}: the plan is resident")
        kn, pn = _copy(nodes), _copy(nodes)
        got, kn = scan_kernel._launch(pods, kn, (1, 1, 1), plan)
        ev0, ev1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        ev0.record()
        ref, pn = scan_kernel.plain_scan_with_state(pods, pn, (1, 1, 1))
        ev1.record()
        torch.cuda.synchronize()
        max_err = max(max_err, _compare(torch, tag, got, kn, ref, pn, phase="parity_in_place"))
        cases += 1
        if not timed:
            return
        # The kernel in place and, where the slices fit, resident, on
        # the same inputs (CUDA events, median of 3 after a warm-up).
        ms, _, _ = _time_ms(torch, pods, nodes, plan)
        bound = kernel_bound(torch, pods, nodes)
        line = {"case": tag, "nodes": int(nodes["cpu_cap"].shape[0]), "cluster": plan.cluster,
                "threads": plan.threads, "smem_bytes": plan.smem_bytes,
                "placed": int((ref >= 0).sum().item()), "ms": ms,
                "per_pod_us": ms * 1e3 / max(bound["placeable_pods"], 1),
                "plain_ms": ev0.elapsed_time(ev1), **bound}
        resident = scan_kernel.plan_for(pods, nodes, plan.cluster, plan.threads)
        if resident.resident:
            line["resident_ms"] = _time_ms(torch, pods, nodes, resident)[0]
        plans.append(line)

    for seed in range(4):
        pending, nodes, assigned, services = workload.small_cluster(seed)
        d = device_snapshot(build_snapshot(pending, nodes, assigned, services), device)
        for C in (1, 4, 16):
            held(f"small seed {seed}, {C} CTAs", d.pods, d.nodes,
                 scan_kernel.plan_for(d.pods, d.nodes, C, None, False))
    tiles = []

    def tiled(tag, pods, nodes, plan):
        nonlocal cases, max_err
        kn, pn = _copy(nodes), _copy(nodes)
        got, kn = scan_kernel._launch(pods, kn, (1, 1, 1), plan)
        ref, pn = scan_kernel.plain_scan_with_state(pods, pn, (1, 1, 1))
        torch.cuda.synchronize()
        max_err = max(max_err, _compare(torch, tag, got, kn, ref, pn, phase="parity_in_place"))
        cases += 1
        tiles.append({"case": tag, "row_words": plan.row_words, "tile": plan.tile,
                      "resident": plan.resident, "cluster": plan.cluster,
                      "placed": int((ref >= 0).sum().item())})

    pending, nodes, services = workload.synthetic_objects(300, 45, seed=11)
    d = device_snapshot(build_snapshot(pending, nodes, services=services), device, 1)
    wp, wn = _widen(torch, d.pods, d.nodes, 4)
    for tile in scan_kernel.TILES + (0,):
        for resident in (True, False):
            tiled(f"300 pods of ties, tile {tile}, {'resident' if resident else 'in place'}",
                  wp, wn, scan_kernel.plan_for(wp, wn, 4, None, resident, tile))
    for words in (320, 3692):  # rows of 348 and 3,720 words
        # Random label bits past the real words on the nodes; every third
        # pod selects one bit of them.
        P, N, sw = d.pods["sel"].shape[0], d.nodes["labels"].shape[0], d.pods["sel"].shape[1]
        gen = torch.Generator(device=device).manual_seed(words)
        high = torch.randint(-2**31, 2**31 - 1, (N, words - sw), dtype=torch.int32, device=device,
                             generator=gen)
        sel = torch.zeros((P, words - sw), dtype=torch.int32, device=device)
        rows = torch.arange(0, P, 3, device=device)
        sel[rows, (rows * 7919) % (words - sw)] = torch.bitwise_left_shift(
            torch.ones_like(rows, dtype=torch.int32), (rows % 31).to(torch.int32))
        wp, wn = _widen(torch, d.pods, d.nodes, 4)
        wp = dict(wp, sel=torch.cat([d.pods["sel"], sel], 1).contiguous())
        wn = dict(wn, labels=torch.cat([d.nodes["labels"], high], 1).contiguous())
        for C in (1, 16):
            plan = scan_kernel.plan_for(wp, wn, C)
            tiled(f"300 pods, {plan.row_words}-word rows, {C} CTAs", wp, wn, plan)
    pods0, carry0 = chunk_state
    pods = {k: v[:IN_PLACE_PODS].contiguous() for k, v in pods0.items()}
    plan = scan_kernel.plan_for(pods, carry0, resident=False)
    for r in range(2):
        held(f"first {IN_PLACE_PODS} pods of the 50k backlog, 5,120 nodes, run {r}", pods, carry0,
             plan, timed=r == 1)
    pending, nodes, services = workload.synthetic_objects(IN_PLACE_PODS, IN_PLACE_NODES, seed=4)
    d = device_snapshot(build_snapshot(pending, nodes, services=services), device)
    held(f"{IN_PLACE_PODS} pods on {IN_PLACE_NODES} nodes, default plan", d.pods, d.nodes,
         scan_kernel.plan_for(d.pods, d.nodes), timed=True)
    cut = {k: v[:SESSION_IN_PLACE_NODES].contiguous() for k, v in d.nodes.items()}
    wp, wn = _widen(torch, d.pods, cut, 4)
    held(f"{IN_PLACE_PODS} pods on {SESSION_IN_PLACE_NODES} nodes, 4-word bitsets, default plan",
         wp, wn, scan_kernel.plan_for(wp, wn), timed=True)
    launches = scan_kernel.scan_with_state.launches
    return {"cases": cases, "launches": launches,
            "resident_limit_nodes": {"main_widths": scan_kernel.max_nodes(2, 2, 2, 8),
                                     "session_widths": scan_kernel.max_nodes(4, 4, 4, 8)},
            "timed": plans, "tiles": tiles, "max_abs_err": max_err,
            "tolerance": "exact (torch.equal)"}


# ---------------------------------------------------------------------------
# Phase 5: the main path
# ---------------------------------------------------------------------------


def run_main_path(torch, device, reference):
    from kubernetes_tpu_torch import workload
    from kubernetes_tpu_torch.ops import ledger, scan_kernel
    from kubernetes_tpu_torch.scheduler.batch import schedule_backlog
    from kubernetes_tpu_torch.utils import sli
    from kubernetes_tpu_torch.utils.tracing import PhaseTimer

    node_names = {f"n{j}" for j in range(N_NODES)}  # synthetic_objects' node names
    calls = [ledger.DEFAULT.calls("scan_kernel")]

    def check(r, names, launches):
        if launches == 0:
            fail("main", "solve_backlog_pipelined launched no scan kernel")
        ledger_calls = ledger.DEFAULT.calls("scan_kernel") - calls[-1]
        calls.append(ledger.DEFAULT.calls("scan_kernel"))
        if ledger_calls != launches:
            fail("main", f"the kernel ledger counted {ledger_calls} launches, the wrapper {launches}")
        if len(names) != N_PODS or any(n is not None and n not in node_names for n in names):
            fail("main", "result has the wrong length or unknown node names")
        if not any(n is not None for n in names):
            fail("main", "no pod placed")
        if r == 0 and names[: len(reference)] != reference:
            bad = sum(a != b for a, b in zip(names, reference))
            fail("main", f"{bad} names differ from the plain version's")
        return {"ledger_calls": ledger_calls}

    torch.cuda.reset_peak_memory_stats()
    runs, first_names = time_backlog(torch, device, MAIN_REPEATS, check)

    pending, nodes, services = workload.synthetic_objects(N_PODS, N_NODES, seed=2)
    timer = PhaseTimer()
    scan_kernel.scan_with_state.launches = 0
    t0 = time.perf_counter()
    names = schedule_backlog(pending, nodes, services=services, device=device, timer=timer)
    wall = time.perf_counter() - t0
    batch_launches = scan_kernel.scan_with_state.launches
    if batch_launches == 0:
        fail("main", "schedule_backlog launched no scan kernel")
    if names != first_names:
        fail("main", "schedule_backlog disagrees with solve_backlog_pipelined")

    torch.cuda.synchronize()
    sli.observe_device_telemetry()
    memory = {kind: sli.DEVICE_MEMORY.value(kind=kind) for kind in ("in_use", "peak", "limit")}
    pending, nodes, services = workload.synthetic_objects(N_PODS, N_NODES, seed=2)
    split = lower_split(pending, nodes, (), services)

    walls = wall_stats(runs)
    return {
        "backlog": f"{N_PODS} pods x {N_NODES} nodes, {N_PODS // 100} services",
        "lower_split": split,
        "device_memory_bytes": memory,
        "runs": runs,
        **walls,
        "pods_per_s_median": N_PODS / walls["wall_s_median"],
        "launches_last_run": runs[-1]["launches"],
        "checked_against_plain": len(reference),
        "schedule_backlog": {"wall_s": wall, "launches": batch_launches,
                             "phases_s": timer.seconds, "equal_to_pipelined": True},
        "first_names": first_names,
    }


# ---------------------------------------------------------------------------
# Phase 5a: the host lowering helper (g++) against its NumPy versions
# ---------------------------------------------------------------------------

NATIVE_HELPERS = ("pack_bitsets", "or_rows_by_index", "greedy_fit")
NATIVE_REPEATS = 3
# greedy_fit's arguments written in place (the NumPy version's too).
_IN_PLACE = {"pack_bitsets": (), "or_rows_by_index": (2,), "greedy_fit": (5, 6, 7, 8, 9, 10)}


def _helper_calls(build):
    """Every call the columnar lowering makes to the native helpers while
    `build()` runs, with copies of the arguments it was given."""
    import types

    import numpy as np

    from kubernetes_tpu_torch import native
    from kubernetes_tpu_torch.models import columnar

    calls = []

    def recorder(name):
        fn = getattr(native, name)

        def call(*args):
            calls.append((name, tuple(np.copy(a) if isinstance(a, np.ndarray) else a for a in args)))
            return fn(*args)
        return call

    saved = columnar.native
    columnar.native = types.SimpleNamespace(**{n: recorder(n) for n in NATIVE_HELPERS})
    try:
        build()
    finally:
        columnar.native = saved
    return calls


def _run_helper(fn, name, args):
    """One helper call on fresh copies of its in-place arguments: (the
    outputs, seconds)."""
    import numpy as np

    args = tuple(np.copy(a) if i in _IN_PLACE[name] else a for i, a in enumerate(args))
    t0 = time.perf_counter()
    out = fn(*args)
    seconds = time.perf_counter() - t0
    return ([out] if name == "pack_bitsets" else [args[i] for i in _IN_PLACE[name]]), seconds


def run_native(build_records, placed_names):
    """The g++ helper on the 50k x 5k backlog's pod columns and on the
    churn session's 50,000 assigned pods (their node columns): every call
    the lowering makes, replayed through the helper and through the NumPy
    version, each output equal exactly; the helper's and NumPy's ms."""
    import numpy as np

    from kubernetes_tpu_torch import native, workload
    from kubernetes_tpu_torch.models import columnar

    pending, nodes, services = workload.synthetic_objects(N_PODS, N_NODES, seed=2)
    cnodes, cservices, assigned = _churn_cluster(placed_names)
    cases = {
        "backlog_pod_columns": _helper_calls(
            lambda: columnar.SnapshotBuilder(pending, nodes, (), services).pod_columns()),
        "assigned_node_columns": _helper_calls(
            lambda: columnar.SnapshotBuilder([], cnodes, assigned, cservices).node_columns()),
    }
    out = {"gxx": [{k: r[k] for k in ("name", "seconds", "built")}
                   for r in build_records if r.get("tool") == "g++"],
           "library": native.ensure_built(), "assigned_pods": len(assigned)}
    if not out["gxx"]:
        fail("native", "the build phase built no host helper with g++")
    for tag, calls in cases.items():
        rows = {}
        for name, args in calls:
            got, _ = _run_helper(getattr(native, name), name, args)
            want, _ = _run_helper(getattr(columnar, name), name, args)
            for g, w in zip(got, want):
                if g.dtype != w.dtype or g.shape != w.shape or not np.array_equal(g, w):
                    fail("native", f"{tag}: {name} differs from the NumPy version")
            native_s = min(_run_helper(getattr(native, name), name, args)[1]
                           for _ in range(NATIVE_REPEATS))
            numpy_s = min(_run_helper(getattr(columnar, name), name, args)[1]
                          for _ in range(NATIVE_REPEATS))
            row = rows.setdefault(name, {"calls": 0, "native_ms": 0.0, "numpy_ms": 0.0})
            row["calls"] += 1
            row["native_ms"] += native_s * 1e3
            row["numpy_ms"] += numpy_s * 1e3
        if tag == "assigned_node_columns" and set(rows) != set(NATIVE_HELPERS):
            fail("native", f"the assigned sweep called {sorted(rows)}, not every helper")
        out[tag] = rows
    out["tolerance"] = "exact (dtype, shape, numpy array_equal)"
    out["timed"] = (f"host clock, least of {NATIVE_REPEATS} runs of each recorded call on fresh "
                    "copies of its in-place arguments, summed over the calls")
    return out


# ---------------------------------------------------------------------------
# Phase 5b: churn on the incremental session (BASELINE config 5)
# ---------------------------------------------------------------------------


def _new_session(torch, device, nodes, services, assigned):
    """A session as the incremental daemon builds one (node capacity
    1.25 x the nodes), prewarmed to the tick's pod bucket."""
    from kubernetes_tpu_torch.ops import SolverSession

    t0 = time.perf_counter()
    session = SolverSession(
        nodes, services, assigned, node_capacity=int(len(nodes) * 1.25), device=device
    )
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    warmed = session.prewarm(max_pod_bucket=1024)
    return session, build_s, time.perf_counter() - t0, warmed


def _mirror_check(torch, session, what, phase="churn"):
    """Device rows equal the host mirror, exactly, on every row with no
    pending delta (all fifteen columns, the nine carry fields among
    them)."""
    import numpy as np

    from kubernetes_tpu_torch.ops.matrices import state_to_numpy

    dev = state_to_numpy(session.dev)
    clean = np.ones(session.N_cap, bool)
    clean[sorted(session._dirty)] = False
    for key, col in session.h.items():
        if not np.array_equal(dev[key][clean], col[clean]):
            bad = int((dev[key][clean] != col[clean]).reshape(int(clean.sum()), -1).any(1).sum())
            fail(phase, f"{what}: device column {key} differs from the host mirror on {bad} rows")
    return int(clean.sum())


class _Recorder:
    """Wraps a session's launch: CUDA events around each tick's kernel,
    and for the chosen ticks clones of the pods and the pre-launch carry
    plus the kernel's choices and post-launch carry."""

    def __init__(self, torch, session, capture):
        self.torch, self.capture = torch, set(capture)
        self.events, self.captured = [], {}
        self._launch = session._dispatch
        session._dispatch = self

    def __call__(self, pods, carry):
        torch = self.torch
        k = len(self.events)
        before = None
        if k in self.capture:
            before = ({n: v.clone() for n, v in pods.items()}, {n: v.clone() for n, v in carry.items()})
        ev0, ev1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        ev0.record()
        out = self._launch(pods, carry)
        ev1.record()
        self.events.append((ev0, ev1))
        if before is not None:
            self.captured[k] = (before, out[0].clone(), {n: v.clone() for n, v in carry.items()})
        return out

    def kernel_ms(self):
        self.torch.cuda.synchronize()
        return [a.elapsed_time(b) for a, b in self.events]


def _held_to_plain(torch, captured, tag):
    """The kernel's choices and carry of one tick against the plain
    version on clones of that tick's inputs; returns the plain ms."""
    from kubernetes_tpu_torch.ops import scan_kernel

    (pods, carry), choice, after = captured
    ev0, ev1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    ev0.record()
    ref, ref_nodes = scan_kernel.plain_scan_with_state(pods, carry, (1, 1, 1))
    ev1.record()
    torch.cuda.synchronize()
    _compare(torch, tag, choice, after, ref, ref_nodes, phase="churn")
    return ev0.elapsed_time(ev1)


def _percentile(xs, q):
    import numpy as np

    return float(np.percentile(np.asarray(xs, dtype=np.float64), q))


def _session_gang_tick(session, first_index, n_services):
    """One more tick of churn pods with groups: as many gangs of
    GANG_SIZE as the tick holds (20 of 50), the second of which has a
    member pinned to a node that does not exist, so its minMember of
    GANG_SIZE cannot be reached."""
    import random

    from kubernetes_tpu_torch import workload
    from kubernetes_tpu_torch.ops import SessionGang

    pods = workload.churn_pods(random.Random(99), first_index, CHURN_RATE, n_services)
    gangs = []
    for g in range(CHURN_RATE // GANG_SIZE):
        members = pods[g * GANG_SIZE:(g + 1) * GANG_SIZE]
        if g == 1:
            members[-1].spec.node_name = "no-such-node"
        gangs.append(SessionGang(
            key=f"default/tick-gang{g}", min_member=GANG_SIZE, bound=0,
            pod_keys=frozenset(f"default/{p.metadata.name}" for p in members),
        ))
    for pod in pods:
        session.add_pending(pod)
    return gangs


def _check_session_gangs(results, gangs, rejected):
    """All or nothing: a rejected gang has no pod placed, an accepted
    one at least its minMember less those already bound."""
    dest = dict(results)
    for g in gangs:
        placed = sum(dest[k] is not None for k in g.pod_keys)
        if g.key in rejected and placed:
            fail("churn", f"rejected group {g.key} kept {placed} placements")
        if g.key not in rejected and placed + g.bound < g.min_member:
            fail("churn", f"accepted group {g.key} has {placed} + {g.bound} < {g.min_member}")


def _record_handles(session):
    """The PendingSolve of every tick the session launches, in order."""
    handles = []
    launch = session.solve_async

    def solve_async():
        handle = launch()
        handles.append(handle)
        return handle
    session.solve_async = solve_async
    return handles


def _duty(handles):
    """The duty cycle and overlap of the timed ticks, as the incremental
    daemon works them out (`_observe_device_profile`): the in-flight
    window (launch to result()) over the period since the previous tick
    resolved, and 1 - blocked / in flight. The registry's series are the
    daemon's own (phase 5o); this session-only figure stays out of them."""
    duty, overlap, busy = [], [], 0.0
    for k in range(CHURN_WARMUP, len(handles)):
        h, prev = handles[k], handles[k - 1]
        device_s = h.resolved_mono - h.dispatched_mono
        wall_s = h.resolved_mono - prev.resolved_mono
        if device_s <= 0 or wall_s <= 0:
            continue
        busy += device_s
        duty.append(min(1.0, device_s / wall_s))
        overlap.append(min(1.0, max(0.0, 1.0 - h.block_s / device_s)))
    if not duty:
        fail("churn", "no timed tick had an in-flight window")
    return {"ticks": len(duty), "duty_median": statistics.median(duty), "duty_max": max(duty),
            "overlap_median": statistics.median(overlap), "busy_s": busy,
            "definition": "in-flight window (launch to result()) over the resolve-to-resolve "
                          "period; overlap 1 - blocked / in flight"}


def run_churn(torch, device, placed_names):
    import random

    from kubernetes_tpu_torch import workload
    from kubernetes_tpu_torch.ops import scan_kernel
    from kubernetes_tpu_torch.utils import profiler

    nodes, services, assigned = _churn_cluster(placed_names)
    ticks = CHURN_WARMUP + CHURN_TICKS
    replay = _replay(services, assigned)

    # The synchronous run, timed.
    session, build_s, prewarm_s, warmed = _new_session(torch, device, nodes, services, assigned)
    checked_rows = []
    rec = _Recorder(torch, session, [CHURN_WARMUP - 1 + t for t in CHURN_CHECKED])
    handles = _record_handles(session)
    gc_pauses = GcPauses()
    scan_kernel.scan_with_state.launches = 0
    with gc_pauses:
        records = workload.churn_replay(
            session, **replay,
            on_result=lambda k, _r: checked_rows.append(_mirror_check(torch, session, f"tick {k}")),
        )
    duty = _duty(handles[:ticks])
    launches = scan_kernel.scan_with_state.launches
    if launches != ticks:
        fail("churn", f"{ticks} ticks launched the scan kernel {launches} times")
    kernel_ms = rec.kernel_ms()
    plain_ms = {}
    for t in CHURN_CHECKED:
        k = CHURN_WARMUP - 1 + t
        plain_ms[t] = _held_to_plain(torch, rec.captured[k], f"churn tick {t}")
    timed = records[CHURN_WARMUP:]
    walls = [r.wall_s for r in timed]
    scheduled = sum(d is not None for r in timed for _k, d in r.results)
    if scheduled == 0:
        fail("churn", "no pod placed in the timed ticks")

    # The kernel at the session's shape: the last tick's inputs.
    (pods, carry), _choice, _after = rec.captured[ticks - 1]
    ms_shape, ms_all, _ = _time_ms(torch, pods, carry, None, KERNEL_REPEATS)
    plan = scan_kernel.plan_for(pods, carry)
    bound = kernel_bound(torch, pods, carry)

    # The same operations with a tick in flight while the next tick's
    # creates and deletes land.
    session_p, build_p, _, _ = _new_session(torch, device, nodes, services, assigned)
    handles_p = _record_handles(session_p)
    scan_kernel.scan_with_state.launches = 0
    records_p = workload.churn_replay(
        session_p, **replay, pipelined=True,
        on_result=lambda k, _r: _mirror_check(torch, session_p, f"pipelined tick {k}"),
    )
    duty_p = _duty(handles_p[:ticks])
    launches_p = scan_kernel.scan_with_state.launches
    if launches_p != ticks:
        fail("churn", f"{ticks} pipelined ticks launched the scan kernel {launches_p} times")
    walls_p = [r.wall_s for r in records_p[CHURN_WARMUP:]]
    for k, (a, b) in enumerate(zip(records, records_p)):
        if a.results != b.results:
            bad = sum(x != y for x, y in zip(a.results, b.results))
            fail("churn", f"pipelined tick {k}: {bad} results differ from the synchronous run's")
    for key, col in session.h.items():
        if not (col == session_p.h[key]).all():
            fail("churn", f"host mirror column {key} differs between the two runs")

    # solve_gang on one more tick: the kernel session against the
    # replayed session with the plain version in place of the kernel.
    first = N_PODS + ticks * CHURN_RATE
    gangs = _session_gang_tick(session, first, len(services))
    gangs_p = _session_gang_tick(session_p, first, len(services))
    session_p._dispatch = lambda pods, carry: (
        scan_kernel.plain_scan_with_state(pods, carry, (1, 1, 1))[0], (None, None, None))
    t0 = time.perf_counter()
    results, rejected = session.solve_gang(gangs)
    gang_wall = time.perf_counter() - t0
    results_p, rejected_p = session_p.solve_gang(gangs_p)
    if (results, rejected) != (results_p, rejected_p):
        fail("churn", "solve_gang with the kernel differs from solve_gang with the plain version")
    if rejected != ["default/tick-gang1"]:
        fail("churn", f"solve_gang rejected {rejected}, expected only default/tick-gang1")
    _check_session_gangs(results, gangs, set(rejected))
    session.solve()  # flush the released rows
    _mirror_check(torch, session, "after solve_gang")

    # One more tick of creates and deletes, its solve under torch.profiler.
    rng = random.Random(11)
    for pod in workload.churn_pods(rng, first + CHURN_RATE, CHURN_RATE, len(services)):
        session.add_pending(pod)
    for key in rng.sample(sorted(session._pod_node), CHURN_RATE):
        session.delete_assigned(key)
    launched = scan_kernel.scan_with_state.launches
    tick_results, tick_profile = profiler.profile_call(session.solve)
    launched = scan_kernel.scan_with_state.launches - launched
    seen = sum(k["calls"] for k in tick_profile["top_kernels"] if "scan_kernel" in k["kernel"])
    tick_profile.update(scan_kernel_launched=launched, scan_kernel_in_trace=seen,
                        trace_complete=seen == launched)
    if not any(d is not None for _k, d in tick_results):
        fail("churn", "the profiled tick placed no pod")
    _mirror_check(torch, session, "after the profiled tick")

    total = sum(walls)
    return {
        "session": session,
        "cell": f"{N_NODES} nodes, {len(services)} services, {len(assigned)} assigned pods, "
                f"{CHURN_RATE} creates + {CHURN_RATE} deletes a tick",
        "nodes": N_NODES, "services": len(services), "assigned": len(assigned),
        "N_cap": session.N_cap, "n_launch": session.n_launch,
        "session_build_s": build_s, "prewarm_s": prewarm_s, "prewarm_launches": warmed,
        "ticks_timed": len(timed), "ticks_per_s": len(timed) / total,
        "scheduled_pods_per_s": scheduled / total, "scheduled": scheduled,
        **tick_stats(timed),
        "kernel_ms_median": statistics.median(kernel_ms[CHURN_WARMUP:]),
        "gc_during_replay": gc_pauses.summary(),
        "launches": launches,
        "ticks": [
            {"tick": i - CHURN_WARMUP + 1 if i >= CHURN_WARMUP else f"warmup{i}",
             "wall_s": r.wall_s, "phases_s": r.phases_s, "kernel_ms": kernel_ms[i],
             "created": CHURN_RATE, "deleted": r.deleted,
             "placed": sum(d is not None for _k, d in r.results)}
            for i, r in enumerate(records)
        ],
        "checks": {
            "mirror_rows_checked_per_tick": checked_rows,
            "held_to_plain_ticks": list(CHURN_CHECKED), "plain_ms": plain_ms,
            "tolerance": "exact (torch.equal, numpy array_equal)",
        },
        "duty": duty, "profiled_tick": tick_profile,
        "pipelined": {"session_build_s": build_p, "ticks_per_s": len(walls_p) / sum(walls_p),
                      "duty": duty_p,
                      "scheduled_pods_per_s": scheduled / sum(walls_p),
                      "tick_p50_s": _percentile(walls_p, 50), "tick_p99_s": _percentile(walls_p, 99),
                      "launches": launches_p, "equal_to_synchronous": True},
        "solve_gang": {"gangs": len(gangs), "rejected": rejected, "wall_s": gang_wall,
                       "equal_to_plain": True},
        "kernel_at_session_shape": {
            "shape": {"P": int(pods["cpu"].shape[0]), "N": int(carry["cpu_cap"].shape[0]),
                      "S": int(carry["svc_counts"].shape[1]), "SW": int(pods["sel"].shape[1]),
                      "PW": int(pods["port"].shape[1]), "VW": int(pods["vol_any"].shape[1]),
                      "K": int(pods["svc_ids"].shape[1])},
            "plan": {"cluster": plan.cluster, "threads": plan.threads,
                     "nodes_per_cta": plan.nodes_per_cta, "smem_bytes": plan.smem_bytes},
            "ms": ms_shape, "ms_all": ms_all, "plain_ms": plain_ms[CHURN_CHECKED[-1]],
            "per_pod_us": ms_shape * 1e3 / max(bound["placeable_pods"], 1),
            **bound,
            "timed": "the wrapper's launch on the last timed tick's pods and carry",
        },
    }


# ---------------------------------------------------------------------------
# Phase 5c: gang acceptance
# ---------------------------------------------------------------------------


def _grouped_small_cluster(seed):
    """A small_cluster backlog with a third of its pods in groups, some
    of whose minMembers cannot be reached."""
    import random

    from kubernetes_tpu_torch import workload
    from kubernetes_tpu_torch.models.objects import POD_GROUP_LABEL
    from kubernetes_tpu_torch.scheduler.gang import partition_backlog

    pending, nodes, assigned, services = workload.small_cluster(seed)
    rng = random.Random(seed)
    names = [f"g{i}" for i in range(rng.randint(1, 5))]
    for pod in pending:
        if rng.random() < 0.35:
            pod.metadata.labels[POD_GROUP_LABEL] = rng.choice(names)
    for pod in assigned:
        if rng.random() < 0.3:
            pod.metadata.labels[POD_GROUP_LABEL] = rng.choice(names)
    need = {name: rng.choice([1, 3, 8, 30, None]) for name in names}
    groups = partition_backlog(pending, assigned, lambda ns, n: need[n])
    return pending, nodes, assigned, services, groups


def run_gang(torch, device):
    from kubernetes_tpu_torch import workload
    from kubernetes_tpu_torch.models.objects import POD_GROUP_LABEL
    from kubernetes_tpu_torch.ops import scan_kernel
    from kubernetes_tpu_torch.scheduler.batch import schedule_backlog_gang
    from kubernetes_tpu_torch.scheduler.gang import partition_backlog
    from kubernetes_tpu_torch.utils.tracing import PhaseTimer

    keys = lambda gs: [g.key for g in gs]
    small = []
    for seed in range(8):
        pending, nodes, assigned, services, groups = _grouped_small_cluster(seed)
        scan_kernel.scan_with_state.launches = 0
        got = schedule_backlog_gang(pending, nodes, assigned, services, groups, device=device)
        rounds = scan_kernel.scan_with_state.launches
        ref = schedule_backlog_gang(pending, nodes, assigned, services, groups, device="cpu")
        if got[0] != ref[0] or keys(got[1]) != keys(ref[1]) or keys(got[2]) != keys(ref[2]):
            fail("gang", f"small cluster {seed}: the card and the CPU disagree")
        small.append({"seed": seed, "pods": len(pending), "groups": len(groups),
                      "rejected": len(got[2]), "rounds": rounds})
    if not any(c["rejected"] and c["rounds"] > 1 for c in small):
        fail("gang", "no small case rejected a group and re-solved")

    # The 50k x 5k backlog in groups of 50; in every 100th group one
    # member is pinned to a node that does not exist, so it cannot
    # reach its minMember of 50.
    pending, nodes, services = workload.synthetic_objects(N_PODS, N_NODES, seed=2)
    for i, pod in enumerate(pending):
        g = i // GANG_SIZE
        pod.metadata.labels[POD_GROUP_LABEL] = f"gang{g}"
        if g % 100 == 0 and i % GANG_SIZE == 0:
            pod.spec.node_name = "no-such-node"
    groups = partition_backlog(pending, min_member_of=lambda ns, n: GANG_SIZE)
    timer = PhaseTimer()
    scan_kernel.scan_with_state.launches = 0
    t0 = time.perf_counter()
    dests, accepted, rejected = schedule_backlog_gang(
        pending, nodes, services=services, groups=groups, device=device, timer=timer
    )
    wall = time.perf_counter() - t0
    rounds = scan_kernel.scan_with_state.launches
    if rounds < 2:
        fail("gang", f"the 50k x 5k gang solve took {rounds} round(s), expected at least 2")
    for g in accepted:
        placed = sum(dests[i] is not None for i in g.indices)
        if placed + g.bound < g.min_member:
            fail("gang", f"accepted {g.key} has {placed} placed, under minMember {g.min_member}")
    for g in rejected:
        if any(dests[i] is not None for i in g.indices):
            fail("gang", f"rejected {g.key} kept placements")
    if not accepted or not rejected:
        fail("gang", f"expected accepted and rejected groups, got {len(accepted)} / {len(rejected)}")
    return {
        "small": small,
        "backlog": {
            "pods": N_PODS, "nodes": N_NODES, "groups": len(groups), "group_size": GANG_SIZE,
            "accepted": len(accepted), "rejected": len(rejected),
            "placed": sum(d is not None for d in dests), "rounds": rounds,
            "launches": rounds, "wall_s": wall, "phases_s": timer.seconds,
            "all_or_nothing": True,
        },
    }


# ---------------------------------------------------------------------------
# Phase 5d-5g: policy specs, explain, the sidecar
# ---------------------------------------------------------------------------


# The launch plans every policy_parity case runs at: the default plan,
# clusters of 1 and 4 CTAs, and 1 and 16 CTAs in place (slices, count
# rows and zone sums in device memory).
POLICY_PARITY_PLANS = (
    ("default", {}), ("cluster 1", {"cluster": 1}), ("cluster 4", {"cluster": 4}),
    ("cluster 1 in place", {"cluster": 1, "resident": False}),
    ("cluster 16 in place", {"cluster": 16, "resident": False}),
)


def _policy_kernel_vs_plain(torch, tag, pods, nodes, weights, lspec, phase="policy_parity",
                            plans=POLICY_PARITY_PLANS):
    """The policy kernel at each of `plans` against one run of the plain
    version on the same inputs; returns the largest error and the
    cluster sizes run."""
    from kubernetes_tpu_torch.ops import policy_scan

    pn = _copy(nodes)
    ref, pn = policy_scan.plain_policy_scan_with_state(pods, pn, weights, lspec)
    err, sizes = 0.0, []
    for name, kw in plans:
        plan = policy_scan.plan_for(pods, nodes, lspec, None, kw.get("cluster"), kw.get("resident"))
        kn = _copy(nodes)
        if name == "default":
            got, kn = policy_scan.policy_scan_with_state(pods, kn, weights, lspec)
        else:
            got, kn = policy_scan._launch(pods, kn, weights, lspec, plan)
        torch.cuda.synchronize()
        err = max(err, _compare(torch, f"{tag}, {name} ({plan.cluster} CTAs)", got, kn, ref, pn,
                                phase=phase))
        sizes.append(plan.cluster)
    return err, sizes


def _policy_edge_cases(torch, device):
    """The cluster's edges under policies, as (tag, pods, nodes, weights,
    lspec): ties between nodes of different CTAs and pods that fit
    nowhere between placed ones; zones with nodes in every CTA; anchors
    in other CTAs' slices; fewer nodes than CTAs; two anti-affinity
    instances, one of weight 0; crowded services whose every step
    exchanges the zone sums; 4-word port bitsets, which take the
    kernel's runtime-width instance; a zone label with a value per
    node."""
    from kubernetes_tpu_torch import workload
    from kubernetes_tpu_torch.models.algspec import spec_from_policy
    from kubernetes_tpu_torch.models.columnar import build_snapshot
    from kubernetes_tpu_torch.ops.matrices import device_snapshot

    def objects(policy, n_pods, n_nodes, seed, host_ports=0, host_label=False):
        pending, nodes, assigned, services = workload.policy_objects(
            n_pods, n_nodes, seed=seed, host_ports=host_ports)
        for j, node in enumerate(nodes if host_label else ()):
            node.metadata.labels["host"] = f"h{j}"
        d = device_snapshot(build_snapshot(pending, nodes, assigned, services,
                                           spec=spec_from_policy(policy)), device, 1)
        return d.pods, d.nodes, d.weights, d.lowered

    full = workload.FULL_VOCABULARY_POLICY
    pods, nodes, weights, lspec = objects(full, 600, 45, 11)
    pods["pinned"][1::9] = -2
    pods["pinned"][2::13] = 45 + 3
    pods["pinned"][3::9] = -2
    yield "ties and unplaceable pods", pods, nodes, weights, lspec
    rack = {"predicates": workload.POLICY_SHAPES["anti_affinity_one"]["predicates"],
            "priorities": [{"name": "LeastRequestedPriority", "weight": 1},
                           {"name": "spread-rack", "weight": 2,
                            "argument": {"serviceAntiAffinity": {"label": "rack"}}}]}
    yield ("zones with nodes in every CTA", *objects(rack, 400, 40, 3))
    yield ("anchors in other CTAs", *objects(workload.POLICY_SHAPES["service_affinity"], 600, 40, 5))
    for n in (1, 3, 13):
        yield (f"{n} nodes, fewer than the CTAs", *objects(full, 200, n, 6))
    pods, nodes, weights, lspec = objects(workload.POLICY_SHAPES["anti_affinity_one"], 300, 40, 2)
    nz = lspec.aa_zones[0]
    lspec = lspec._replace(aa_weights=(0, lspec.aa_weights[0]), aa_zones=(nz, nz))
    nodes = dict(nodes, aa_zone=nodes["aa_zone"].repeat(1, 2).contiguous())
    yield "two instances, one of weight 0", pods, nodes, weights, lspec
    pending, nodes, services = workload.synthetic_objects(400, 6, seed=9)
    for j, node in enumerate(nodes):
        node.metadata.labels["rack"] = f"r{j % 3}"
    d = device_snapshot(build_snapshot(pending, nodes, services=services,
                                       spec=spec_from_policy(full)), device, 1)
    yield "crowded services on 6 nodes", d.pods, d.nodes, d.weights, d.lowered
    pods, nodes, weights, lspec = objects(full, 400, 40, 7, host_ports=70)
    widths = tuple(pods[k].shape[1] for k in ("sel", "port", "vol_any", "svc_ids"))
    if widths == (2, 2, 2, 8):
        fail("policy_parity", "the 70-port case lowered to the unrolled widths")
    yield "4-word port bitsets (runtime widths)", pods, nodes, weights, lspec
    host = {"predicates": workload.POLICY_SHAPES["anti_affinity_one"]["predicates"],
            "priorities": [{"name": "LeastRequestedPriority", "weight": 1},
                           {"name": "spread-host", "weight": 3,
                            "argument": {"serviceAntiAffinity": {"label": "host"}}}]}
    yield ("a zone per node", *objects(host, 600, 200, 4, host_label=True))


def check_policy_parity(torch, device):
    from kubernetes_tpu_torch import workload
    from kubernetes_tpu_torch.models.algspec import spec_from_policy
    from kubernetes_tpu_torch.models.columnar import build_snapshot
    from kubernetes_tpu_torch.ops import policy_scan
    from kubernetes_tpu_torch.ops.matrices import device_snapshot

    cases, runs, max_err, shapes, sizes = 0, 0, 0.0, {}, set()
    for shape, policy in workload.POLICY_SHAPES.items():
        spec = spec_from_policy(policy)
        for seed in range(4):
            pending, nodes, assigned, services = workload.policy_cluster(seed)
            d = device_snapshot(build_snapshot(pending, nodes, assigned, services, spec=spec), device)
            err, ran = _policy_kernel_vs_plain(
                torch, f"{shape} seed {seed}", d.pods, d.nodes, d.weights, d.lowered)
            max_err, cases, runs = max(max_err, err), cases + 1, runs + len(ran)
            sizes.update(ran)
        shapes[shape] = str(d.lowered)
    for tag, pods, nodes, weights, lspec in _policy_edge_cases(torch, device):
        err, ran = _policy_kernel_vs_plain(torch, tag, pods, nodes, weights, lspec)
        max_err, cases, runs = max(max_err, err), cases + 1, runs + len(ran)
        sizes.update(ran)
    # Past the eight instances and eight labels the kernel keeps in its
    # arguments and registers: 9 and 12 anti-affinity instances and 9
    # affinity labels on 40 nodes at every plan, and 9 instances on the
    # policy backlog's 5,000 nodes at the default plan.
    before = policy_scan.policy_scan_with_state.launches
    past_8 = []
    for n_aa, n_aff, n_pods, n_nodes, plans in ((9, 1, 400, 40, POLICY_PARITY_PLANS),
                                                (12, 1, 400, 40, POLICY_PARITY_PLANS),
                                                (1, 9, 400, 40, POLICY_PARITY_PLANS),
                                                (12, 9, 400, 40, POLICY_PARITY_PLANS),
                                                (9, 1, 1024, 5000, POLICY_PARITY_PLANS[:1])):
        pending, nodes, assigned, services = workload.wide_objects(n_pods, n_nodes, seed=3)
        spec = spec_from_policy(workload.wide_policy(n_aa, n_aff))
        d = device_snapshot(build_snapshot(pending, nodes, assigned, services, spec=spec), device, 1)
        tag = f"{n_aa} anti-affinity instances, {n_aff} affinity labels, {n_nodes} nodes"
        err, ran = _policy_kernel_vs_plain(torch, tag, d.pods, d.nodes, d.weights, d.lowered,
                                           plans=plans)
        max_err, cases, runs = max(max_err, err), cases + 1, runs + len(ran)
        sizes.update(ran)
        past_8.append(tag)
    past_8_launches = policy_scan.policy_scan_with_state.launches - before
    # The last case timed at its default plan, beside the same pods under
    # the full vocabulary's one instance.
    ms, _, _ = _policy_time_ms(torch, d.pods, d.nodes, d.weights, d.lowered, 3)
    plan = policy_scan.plan_for(d.pods, d.nodes, d.lowered)
    bound = policy_kernel_bound(torch, d.pods, d.nodes, d.lowered)
    one = d.lowered._replace(aa_weights=d.lowered.aa_weights[:1], aa_zones=d.lowered.aa_zones[:1])
    one_nodes = dict(d.nodes, aa_zone=d.nodes["aa_zone"][:, :1].contiguous())
    ms_one, _, _ = _policy_time_ms(torch, d.pods, one_nodes, d.weights, one, 3)
    past_8_timing = {"case": tag, "ms": ms, "per_pod_us": ms * 1e3 / max(bound["placeable_pods"], 1),
                     "cluster": plan.cluster, "resident": plan.resident,
                     "one_instance_ms": ms_one, **bound}
    return {"cases": cases, "kernel_runs": runs, "cluster_sizes": sorted(sizes),
            "past_8": {"cases": past_8, "launches": past_8_launches, "timed": past_8_timing},
            "plans": [name for name, _ in POLICY_PARITY_PLANS], "shapes": shapes,
            "max_abs_err": max_err,
            "tolerance": "exact (torch.equal; anchor and svc_total included)"}


def policy_kernel_bound(torch, pods, carry, lspec):
    """The least time the card could take for one policy scan launch on
    these inputs: `policy_scan.cost` over the pods some node could take
    (under HostName; every pod without it)."""
    from kubernetes_tpu_torch.ops import policy_scan

    d = policy_scan._dims(pods, carry, lspec)
    pin = pods["pinned"]
    placeable = (int(((pin == -1) | ((pin >= 0) & (pin < d["N"]))).sum().item())
                 if lspec.hostname else d["P"])
    return _bound(policy_scan.cost(**d, placeable=placeable), placeable_pods=placeable)


def _policy_time_ms(torch, pods, carry, weights, lspec, reps, plan=None):
    """Median CUDA-event ms of `reps` policy kernel launches after a
    warm-up, each from a fresh copy of `carry`; and the last result."""
    from kubernetes_tpu_torch.ops import policy_scan

    times, out = [], None
    for _ in range(reps + 1):
        nodes = _copy(carry)
        torch.cuda.synchronize()
        ev0, ev1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        ev0.record()
        out = policy_scan._launch(pods, nodes, weights, lspec, plan)
        ev1.record()
        torch.cuda.synchronize()
        times.append(ev0.elapsed_time(ev1))
    return statistics.median(times[1:]), times[1:], out


def run_policy(torch, device):
    from kubernetes_tpu_torch.models.columnar import build_snapshot
    from kubernetes_tpu_torch.ops import policy_scan, scan_kernel
    from kubernetes_tpu_torch.ops.matrices import device_snapshot

    node_names = {f"n{j}" for j in range(N_NODES)}  # policy_objects' node names
    first = []

    def check(r, got, launches):
        if launches != 1 or scan_kernel.scan_with_state.launches:
            fail("policy", f"the policy backlog made {launches} policy kernel launches and "
                           f"{scan_kernel.scan_with_state.launches} scan kernel launches, expected 1 and 0")
        if len(got) != N_PODS or any(n is not None and n not in node_names for n in got):
            fail("policy", "result has the wrong length or unknown node names")
        if first and got != first[0]:
            fail("policy", f"run {r}: {sum(a != b for a, b in zip(got, first[0]))} decisions "
                           "differ from the first run's")
        first.append(got)
        return {}

    scan_kernel.scan_with_state.launches = 0
    runs, names, objs, spec, objects_s = time_policy(torch, device, POLICY_REPEATS, check)
    pending, nodes, assigned, services = objs
    placed = runs[-1]["placed"]
    if placed == 0:
        fail("policy", "no pod placed")
    split = lower_split(pending, nodes, assigned, services, spec)

    # The kernel alone on the whole backlog, and the first POLICY_CHECKED
    # pods against the plain version, decisions and carry.
    d = device_snapshot(build_snapshot(pending, nodes, assigned, services, spec=spec), device)
    ms_all_pods, _, (choice, _) = _policy_time_ms(torch, d.pods, d.nodes, d.weights, d.lowered, 1)
    index = {n.metadata.name: j for j, n in enumerate(nodes)}
    if [index[n] if n is not None else -1 for n in names] != choice[:N_PODS].tolist():
        fail("policy", "schedule_backlog disagrees with the kernel launched on its snapshot")
    head = {k: v[:POLICY_CHECKED].contiguous() for k, v in d.pods.items()}
    ms, ms_runs, (got, got_nodes) = _policy_time_ms(torch, head, d.nodes, d.weights, d.lowered, 3)
    ref_nodes = _copy(d.nodes)
    ev0, ev1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    ev0.record()
    ref, ref_nodes = policy_scan.plain_policy_scan_with_state(head, ref_nodes, d.weights, d.lowered)
    ev1.record()
    torch.cuda.synchronize()
    plain_ms = ev0.elapsed_time(ev1)
    err = _compare(torch, f"first {POLICY_CHECKED} pods of the policy backlog", got, got_nodes,
                   ref, ref_nodes, phase="policy")
    if got.tolist() != choice[:POLICY_CHECKED].tolist():
        fail("policy", "the kernel on the first pods disagrees with its run on the whole backlog")
    bound = policy_kernel_bound(torch, head, d.nodes, d.lowered)
    full_bound = policy_kernel_bound(torch, d.pods, d.nodes, d.lowered)
    plan = policy_scan.plan_for(d.pods, d.nodes, d.lowered)
    if plan.cluster < 2:
        fail("policy", f"the policy backlog's plan is a cluster of {plan.cluster} CTA")
    walls = wall_stats(runs)
    return {
        "backlog": f"{N_PODS} pods x {N_NODES} nodes, {len(services)} services, "
                   f"{len(assigned)} bound peers, FULL_VOCABULARY_POLICY",
        "lowered": str(d.lowered), "weights": list(d.weights),
        "objects_s": objects_s,
        "lower_split": split,
        "runs": runs,
        **walls,
        "pods_per_s_median": N_PODS / walls["wall_s_median"],
        "placed": placed,
        "launches_last_run": runs[-1]["launches"],
        "identical_runs": len(runs),
        "kernel_ms": ms_all_pods,
        "kernel_per_pod_us": ms_all_pods * 1e3 / max(full_bound["placeable_pods"], 1),
        "kernel_bound_ms": full_bound["bound_ms"],
        "plan": {"cluster": plan.cluster, "nodes_per_cta": plan.nodes_per_cta,
                 "threads": plan.threads, "smem_bytes": plan.smem_bytes,
                 "resident": plan.resident, "zone_bins": plan.zone_bins,
                 "row_words": plan.row_words,
                 "max_active_clusters": policy_scan.occupancy(plan, d.pods, d.nodes, d.lowered)},
        "shape": {"P": int(d.pods["cpu"].shape[0]), "N": int(d.nodes["cpu_cap"].shape[0]),
                  "S": int(d.nodes["svc_counts"].shape[1]), "SA": int(d.nodes["anchor"].shape[0])},
        "checked_against_plain": POLICY_CHECKED,
        "names": names,
        "sweep_state": (head, d.nodes, d.weights, d.lowered),
        "timing": {
            "ms": ms, "ms_all": ms_runs, "plain_ms": plain_ms, "max_abs_err": err,
            "per_pod_us": ms * 1e3 / max(bound["placeable_pods"], 1), **bound,
            "timed": f"the wrapper's launch on the first {POLICY_CHECKED} pods of the policy "
                     "backlog and its staged carry, layout conversion included",
        },
    }


POLICY_SWEEP_NODES = (1024, 5120, 20480)
POLICY_SWEEP_CLUSTERS = (1, 4, 8, 16)
#: Pods of each sweep row held to the plain version.
SWEEP_CHECKED = 256


def _node_axis(nodes, n):
    """The node columns cut or repeated to n nodes (the service carry,
    indexed by service, unchanged)."""
    from kubernetes_tpu_torch.ops.matrices import POLICY_CARRY_KEYS

    N = nodes["cpu_cap"].shape[0]
    return {k: v if k in POLICY_CARRY_KEYS else v.repeat((-(-n // N),) + (1,) * (v.dim() - 1))[:n].contiguous()
            for k, v in nodes.items()}


def time_policy_kernel(torch, state):
    """K1P's µs a pod on the policy backlog's first pods, against the
    first 1,024, the 5,120 and those repeated to 20,480 nodes, for a spec
    with no anti-affinity (one cluster barrier a step), with one
    instance and nothing else of the policy, and the full vocabulary (a
    second barrier on every step with peers), on clusters of 1, 4, 8
    and 16 CTAs. Every configuration's decisions and carry must equal
    the default plan's on the same inputs, and the default plan must
    equal the plain version on the first SWEEP_CHECKED pods."""
    from kubernetes_tpu_torch.models.algspec import LoweredSpec
    from kubernetes_tpu_torch.ops import policy_scan
    from kubernetes_tpu_torch.ops.matrices import CARRY_KEYS, POLICY_CARRY_KEYS

    pods, nodes0, weights, full = state
    P = pods["cpu"].shape[0]
    specs = {
        "no_anti_affinity": full._replace(aa_weights=(), aa_zones=()),
        "one_instance": LoweredSpec(aa_weights=full.aa_weights, aa_zones=full.aa_zones),
        "full_vocabulary": full,
    }
    out, plans = {}, {}
    for tag, lspec in specs.items():
        out[tag] = {}
        for n in POLICY_SWEEP_NODES:
            nodes = _node_axis(nodes0, n)
            base = policy_scan.plan_for(pods, nodes, lspec)
            head = {k: v[:SWEEP_CHECKED].contiguous() for k, v in pods.items()}
            _policy_kernel_vs_plain(torch, f"sweep {tag} at {n} nodes, first {SWEEP_CHECKED} pods",
                                    head, nodes, weights, lspec, "kernel_timing",
                                    (("default", {}),))
            _, _, (ref, ref_nodes) = _policy_time_ms(torch, pods, nodes, weights, lspec, 1, base)
            row = {}
            for C in POLICY_SWEEP_CLUSTERS:
                plan = policy_scan.plan_for(pods, nodes, lspec, None, C)
                ms, _, (got, got_nodes) = _policy_time_ms(torch, pods, nodes, weights, lspec, 2, plan)
                for k in ("choice",) + CARRY_KEYS + POLICY_CARRY_KEYS:
                    a, b = (got, ref) if k == "choice" else (got_nodes.get(k), ref_nodes.get(k))
                    if a is not None and not torch.equal(a, b):
                        fail("kernel_timing", f"K1P {tag} at {n} nodes: {C} CTAs differ from "
                                              f"{base.cluster} in {k}")
                row[C] = ms * 1e3 / P
                plans[f"{tag}/{n}/{C}"] = {"resident": plan.resident, "threads": plan.threads,
                                          "smem_bytes": plan.smem_bytes}
            out[tag][n] = row
    return {"pods": P, "per_pod_us": out, "plans": plans,
            "checked_against_plain": f"the default plan of each row on its first {SWEEP_CHECKED} pods",
            "split_per_pod_us": _policy_step_split(torch, pods, nodes0, weights, full),
            "timed": "the wrapper's launch on the policy backlog's first pods, layout "
                     "conversion included; the carry cut or repeated to the node count"}


def _policy_step_split(torch, pods, nodes, weights, full):
    """Where a K1P step's time goes, at the default plan on the same pods
    and nodes: the scan kernel (K1) on the default spec, then K1P on the
    base predicates without and with the service carry, with service
    affinity (anchors read, and all pods pinned so that none is), with
    anti-affinity and no carry (no peers: one barrier a step) and with
    the carry (the zone exchange and a second barrier), and the full
    vocabulary. Not held to the plain version: the specs differ from the
    checked ones, and each kernel is checked elsewhere."""
    from kubernetes_tpu_torch.models.algspec import LoweredSpec
    from kubernetes_tpu_torch.ops import policy_scan
    from kubernetes_tpu_torch.ops.matrices import POLICY_CARRY_KEYS

    P = pods["cpu"].shape[0]
    bare = {k: v for k, v in nodes.items() if k not in POLICY_CARRY_KEYS}
    pinned = dict(pods, aff_pin=torch.zeros_like(pods["aff_pin"]))
    aa = LoweredSpec(aa_weights=full.aa_weights, aa_zones=full.aa_zones)
    variants = {
        "base": (pods, bare, LoweredSpec()),
        "base_with_service_carry": (pods, nodes, LoweredSpec()),
        "service_affinity": (pods, nodes, LoweredSpec(service_affinity=True)),
        "service_affinity_all_pinned": (pinned, nodes, LoweredSpec(service_affinity=True)),
        "anti_affinity_without_peers": (pods, bare, aa),
        "anti_affinity": (pods, nodes, aa),
        "full_vocabulary": (pods, nodes, full),
    }
    ms, _, _ = _time_ms(torch, pods, bare, None, 3)
    split = {"scan_kernel_default_spec": ms * 1e3 / P}
    for tag, (p, n, lspec) in variants.items():
        ms, _, _ = _policy_time_ms(torch, p, n, weights, lspec, 3)
        split[tag] = ms * 1e3 / P
    return split


def run_explain(torch, device):
    from kubernetes_tpu_torch import workload
    from kubernetes_tpu_torch.ops.pipeline import explain_backlog

    pending, nodes, assigned, services = workload.policy_objects(N_PODS, N_NODES, seed=2)
    pods = pending[:EXPLAIN_PODS]
    times, gc_s = [], []
    for _ in range(3):
        torch.cuda.synchronize()
        with GcPauses() as pauses:
            t0 = time.perf_counter()
            got = explain_backlog(pods, nodes, assigned, services, device=device)
            times.append(time.perf_counter() - t0)
        gc_s.append(pauses.summary()["total_s"])
    t0 = time.perf_counter()
    ref = explain_backlog(pods, nodes, assigned, services, device="cpu")
    cpu_s = time.perf_counter() - t0
    if got != ref:
        bad = sum(a != b for a, b in zip(got, ref))
        fail("explain", f"{bad} of {len(ref)} explain entries differ between the card and the CPU")
    return {
        "pods": len(pods), "nodes": len(nodes),
        "ms_median": statistics.median(times[1:]) * 1e3, "ms_all": [t * 1e3 for t in times],
        "gc_ms_all": [t * 1e3 for t in gc_s], "cpu_ms": cpu_s * 1e3,
        "feasible_nodes_median": statistics.median(e["feasibleNodes"] for e in got),
        "equal_to_cpu": True,
        "timed": "explain_backlog wall (lowering, staging, the batched readback, the per-pod "
                 "dicts); first call a warm-up",
    }


def _stop_process(proc):
    if proc.poll() is None:
        proc.terminate()
        try:
            proc.wait(timeout=10)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=10)


def _span_seconds(span):
    """A recorded span's duration and its children's, by name."""
    return {"s": span["duration_s"],
            **{c["name"]: _span_seconds(c) if c.get("children") else c["duration_s"]
               for c in span.get("children", ())}}


def _sidecar_pair_in_thread(objs, expected):
    """The port's server on a thread of this process, sent the default
    backlog twice by the port's client: each trip's wall on the client
    and the server's spans of it (recv, decode, upload, solve, send) from
    `utils.tracing.DEFAULT_BUFFER`, and the client's own lowering timed
    apart. The gap between two trips shows in whichever part it is."""
    import tempfile
    import threading

    from kubernetes_tpu_torch.models.columnar import build_snapshot
    from kubernetes_tpu_torch.ops import sidecar
    from kubernetes_tpu_torch.utils import tracing

    sock_dir = tempfile.mkdtemp(prefix="ktt-sidecar-")
    sock_path = os.path.join(sock_dir, "solver.sock")
    stop = threading.Event()
    server = threading.Thread(target=sidecar.serve, args=(sock_path, None, stop), daemon=True)
    server.start()
    try:
        client = sidecar.SidecarSolver(sock_path, timeout=SIDECAR_WAIT_S)
        deadline = time.monotonic() + SIDECAR_WAIT_S
        while not (os.path.exists(sock_path) and client.ping()):
            if time.monotonic() > deadline or not server.is_alive():
                fail("sidecar", "the server on a thread never answered a ping")
            time.sleep(0.05)
        tracing.DEFAULT_BUFFER.clear()
        trips = []
        for trip in (1, 2):
            t0 = time.perf_counter()
            build_snapshot(*objs)
            lower_s = time.perf_counter() - t0
            with GcPauses() as pauses:
                t0 = time.perf_counter()
                got = client.solve(*objs)
                wall = time.perf_counter() - t0
            if got != expected:
                fail("sidecar", f"in-thread trip {trip}: {sum(a != b for a, b in zip(got, expected))} "
                                "decisions differ from in-process schedule_backlog")
            trips.append({"trip": trip, "wall_s": wall, "client_lowering_alone_s": lower_s,
                          "gc_in_trip": pauses.summary()})
        # The server records a trace once its reply is sent, which the
        # client may see first: wait for the second.
        deadline = time.monotonic() + 10
        while True:
            solves = [t for t in tracing.DEFAULT_BUFFER.to_dicts(limit=16)["traces"]
                      if any(c["name"] == "decode" for c in t["spans"][0].get("children", ()))]
            if len(solves) >= 2 or time.monotonic() > deadline:
                break
            time.sleep(0.01)
        if len(solves) != 2:
            fail("sidecar", f"the server recorded {len(solves)} solve traces for 2 trips")
        for trip, t in zip(trips, reversed(solves)):
            trip["server_spans"] = _span_seconds(t["spans"][0])
        return {"trips": trips, "equal_to_in_process": True,
                "timed": "wall: client clock around SidecarSolver.solve (its lowering, the frame "
                         "both ways, the server); client_lowering_alone: build_snapshot of the "
                         "same objects just before; server_spans: the server thread's trace of "
                         "the request (recv: the frame in, decode, upload, solve ending in the "
                         "read, send); gc_in_trip: the collector's passes during the trip (this "
                         "process's, so the client's and the server thread's). Both threads share "
                         "one interpreter, so a span can end after the client has its reply"}
    finally:
        stop.set()
        server.join(timeout=10)
        shutil.rmtree(sock_dir, ignore_errors=True)
        if server.is_alive():
            fail("sidecar", "the server thread did not stop")


def run_sidecar(torch, device, default_names, policy_names):
    """The port's sidecar as a subprocess on the card, driven by the
    port's own client with the default and the policy 50k backlogs, and
    the default one in modes wave and sinkhorn."""
    import socket

    from kubernetes_tpu_torch import workload
    from kubernetes_tpu_torch.models.algspec import spec_from_policy
    from kubernetes_tpu_torch.models.columnar import build_snapshot
    from kubernetes_tpu_torch.ops import sidecar
    from kubernetes_tpu_torch.scheduler.batch import schedule_backlog_sinkhorn, schedule_backlog_wave

    proc, sock_path = None, None
    t0 = time.perf_counter()
    try:
        proc, sock_path = sidecar.spawn_sidecar(wait=SIDECAR_WAIT_S)
        start_s = time.perf_counter() - t0
        client = sidecar.SidecarSolver(sock_path, timeout=SIDECAR_WAIT_S)
        spec = spec_from_policy(workload.FULL_VOCABULARY_POLICY)
        pending, nodes, services = workload.synthetic_objects(N_PODS, N_NODES, seed=2)
        ppending, pnodes, passigned, pservices = workload.policy_objects(N_PODS, N_NODES, seed=2)
        cases = {
            "default": ((pending, nodes, (), services), None, default_names),
            "policy": ((ppending, pnodes, passigned, pservices), spec, policy_names),
        }
        out = {"start_s": start_s}
        # The server's first request loads the kernels and warms its card.
        client.solve(*cases["default"][0])
        for tag, (objs, spec_, expected) in cases.items():
            snap = build_snapshot(*objs, spec=spec_)
            header, arrays = sidecar._encode({"op": "solve", "mode": "scan",
                                              **sidecar._snapshot_payload(snap)})
            walls, client_gc = [], []
            # The server counts each solve's launches from 0 and returns
            # them with the reply.
            want = {"scan_kernel": int(spec_ is None), "policy_scan_kernel": int(spec_ is not None)}
            for _ in range(2):
                with GcPauses() as pauses:
                    t0 = time.perf_counter()
                    got = client.solve(*objs, spec=spec_)
                    walls.append(time.perf_counter() - t0)
                client_gc.append(pauses.summary()["total_s"])
                if got != expected:
                    bad = sum(a != b for a, b in zip(got, expected))
                    fail("sidecar", f"{tag}: {bad} decisions differ from in-process schedule_backlog")
                if client.last_kernel_launches != want:
                    fail("sidecar", f"{tag}: the server's solve launched "
                                    f"{client.last_kernel_launches}, expected {want}")
            out[tag] = {"round_trip_s": walls, "round_trip_s_min": min(walls),
                        "client_gc_s": client_gc,
                        "request_frame_bytes": 18 + len(header) + sum(a.nbytes for a in arrays),
                        "kernel_launches": client.last_kernel_launches,
                        "equal_to_in_process": True}
        # The JAX daemon's --batch-mode wave|sinkhorn requests: each reply
        # equals the same solve in this process, on the same card.
        none = {"scan_kernel": 0, "policy_scan_kernel": 0}
        for mode, local in (("wave", schedule_backlog_wave), ("sinkhorn", schedule_backlog_sinkhorn)):
            objs = cases["default"][0]
            t0 = time.perf_counter()
            got = client.solve(*objs, mode=mode)
            wall = time.perf_counter() - t0
            t0 = time.perf_counter()
            want = local(*objs, device=device)
            local_s = time.perf_counter() - t0
            if got != want:
                bad = sum(a != b for a, b in zip(got, want))
                fail("sidecar", f"{mode}: {bad} decisions differ from the in-process solve")
            if client.last_kernel_launches != none:
                fail("sidecar", f"{mode}: the server launched {client.last_kernel_launches}")
            out[mode] = {"round_trip_s": wall, "in_process_s": local_s,
                         "placed": sum(n is not None for n in got), "equal_to_in_process": True}
        s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        s.settimeout(10)
        s.connect(sock_path)
        s.sendall(b"GARBAGE" * 100)
        s.close()
        if not client.ping():
            fail("sidecar", "the server did not answer a ping after a garbage frame")
        out["alive_after_garbage"] = True
        out["in_process_server"] = _sidecar_pair_in_thread(cases["default"][0], default_names)
        out["timed"] = ("SidecarSolver.solve wall: client-side lowering, the frame both ways, the "
                        "server's staging, solve and readback")
        return out
    except sidecar.SidecarError as e:
        fail("sidecar", f"sidecar failure: {e}")
    finally:
        if proc is not None:
            _stop_process(proc)
            shutil.rmtree(os.path.dirname(sock_path), ignore_errors=True)


# ---------------------------------------------------------------------------
# Phase 5h-5i: the windowed solvers, wave and Sinkhorn
# ---------------------------------------------------------------------------

WINDOWED_CHECK = (8192, 1024, 7)  # pods, nodes, seed of the backlog held card against CPU
WINDOWED_TICKS = 2  # churn ticks of the session in each windowed mode (3 before PR 17's cut)
PRICE_ATOL = 1e-4  # Sinkhorn's prices and residual, card against CPU, as in the CPU tests
AGREEMENT = 0.99  # Sinkhorn's share of pods on the CPU run's node
# tests/test_quality_regression.py: TestWaveQuality and TestSinkhornQuality.
QUALITY = {"wave": {"mean_regret": 1.5, "p99_regret": 5, "greedy_match": 0.30},
           "sinkhorn": {"mean_regret": 1.5, "p99_regret": 10, "greedy_match": 0.25}}


def _windowed_with_state(mode, pods, nodes, window=4096):
    """(assignment, waves, iterations, residual) of one windowed solve,
    committing into `nodes`; the last two None for the wave."""
    from kubernetes_tpu_torch.ops import sinkhorn, wave

    if mode == "wave":
        a, _, w = wave.solve_waves_with_state(pods, nodes, window=window)
        return a, w, None, None
    a, _, w, it, res = sinkhorn.solve_sinkhorn_with_state(pods, nodes, window=window)
    return a, w, int(it), float(res)


def _assignment_of(snap, names):
    """Node names back to the snapshot's node indices (-1 unplaced)."""
    import numpy as np

    index = {n: j for j, n in enumerate(snap.nodes.names)}
    return np.array([index[n] if n is not None else -1 for n in names], np.int32)


def _valid(phase, snap, assignment, tag):
    from kubernetes_tpu_torch.ops import oracle

    try:
        oracle.validate_assignment_numpy(snap, assignment)
    except AssertionError as e:
        fail(phase, f"{tag}: invalid placement: {e}")


def _card_vs_cpu(torch, device, mode, tag, snap, window, validate=True):
    """One windowed solve of `snap` on the card and on the CPU. The wave
    must be equal (assignment, nine carry fields, waves); Sinkhorn must
    agree on AGREEMENT of the pods and, where every decision agrees, on
    its waves, iterations and residual. With `validate`, the card's
    placements must pass the oracle's validity replay."""
    import numpy as np

    from kubernetes_tpu_torch.ops.matrices import CARRY_KEYS, device_snapshot, state_to_numpy
    from kubernetes_tpu_torch.ops.wave import strip_assignments

    # Staging on the CPU shares the snapshot's arrays: the solves commit
    # into copies, so the snapshot stays the one the oracle replays.
    dc, dh = device_snapshot(snap, device), device_snapshot(snap, "cpu")
    card_nodes, cpu_nodes = _copy(dc.nodes), _copy(dh.nodes)
    t0 = time.perf_counter()
    card = _windowed_with_state(mode, dc.pods, card_nodes, window)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    cpu = _windowed_with_state(mode, dh.pods, cpu_nodes, window)
    cpu_s = time.perf_counter() - t0
    a_card, a_cpu = card[0].cpu().numpy(), cpu[0].numpy()
    agree = float((a_card == a_cpu).mean())
    if mode == "wave":
        if agree < 1.0 or card[1] != cpu[1]:
            fail(mode, f"{tag}: the card's wave differs from the CPU's "
                       f"({agree:.4f} of the pods agree, waves {card[1]} and {cpu[1]})")
        got, want = state_to_numpy(card_nodes), state_to_numpy(cpu_nodes)
        for k in CARRY_KEYS:
            if not np.array_equal(got[k], want[k]):
                fail(mode, f"{tag}: carry field {k} differs between the card and the CPU")
    else:
        if agree < AGREEMENT:
            fail(mode, f"{tag}: only {agree:.4f} of the pods agree between the card and the CPU")
        if agree == 1.0 and (card[1:3] != cpu[1:3] or abs(card[3] - cpu[3]) > PRICE_ATOL):
            fail(mode, f"{tag}: equal decisions but telemetry {card[1:]} against {cpu[1:]}")
    if validate:
        _valid(mode, snap, strip_assignments(dc, card[0]), tag)
    return {"case": tag, "window": window, "agreement": agree,
            "waves": card[1], "iterations": card[2], "residual": card[3],
            "cpu": {"waves": cpu[1], "iterations": cpu[2], "residual": cpu[3]},
            "card_s": card_s, "cpu_s": cpu_s}


def _congested_matrix(seed, W=64, N=12):
    """A masked score matrix where many pods want a few nodes of small
    pod-count capacity (the CPU tests' case)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    masked = rng.integers(0, 31, size=(W, N)).astype(np.float32)
    masked[:, :3] += 10
    masked[rng.random((W, N)) < 0.3] = -1
    masked[:4] = -1
    return masked, rng.random(W) < 0.9, rng.choice([0, 1, 2, 5], size=N).astype(np.float32)


def _prices_card_vs_cpu(torch, device, snap):
    """Sinkhorn's congestion prices on the same inputs on the card and
    the CPU: the congested matrices of the CPU tests, and the first
    window of `snap` against its nodes. Iterations run must be equal, the
    prices and residual within PRICE_ATOL."""
    from kubernetes_tpu_torch.ops import sinkhorn, wave
    from kubernetes_tpu_torch.ops.matrices import device_snapshot

    cases = []
    for seed in range(4):
        masked, valid, capacity = _congested_matrix(seed)
        for iters, tol in ((8, 0.0), (20, 0.0), (20, 1.0)):
            cases.append((f"congested seed {seed}, {iters} iterations, tol {tol}",
                          torch.from_numpy(masked), torch.from_numpy(valid),
                          torch.from_numpy(capacity), iters, tol))
    d = device_snapshot(snap, "cpu")
    W = min(4096, d.pods["cpu"].shape[0])
    idx = torch.arange(W, dtype=torch.int32)
    feas, score = wave._batched_eval(wave._window_rows(d.pods, idx), d.nodes, (1, 1, 1))
    masked = torch.where(feas, score, -1).to(torch.float32)
    capacity = (d.nodes["pods_cap"] - d.nodes["pods_used"]).clamp(min=0.0)
    cases.append(("the first window of the checked backlog", masked, idx < d.pods["cpu"].shape[0],
                  capacity, 8, 0.0))
    worst, out = 0.0, []
    for tag, masked, valid, capacity, iters, tol in cases:
        gh, ih, rh = sinkhorn._congestion_prices(masked, valid, capacity, 2.0, iters, tol)
        gc, ic, rc = sinkhorn._congestion_prices(masked.to(device), valid.to(device),
                                                 capacity.to(device), 2.0, iters, tol)
        err = float((gc.cpu() - gh).abs().max())
        rerr = abs(float(rc) - float(rh))
        if int(ic) != int(ih) or err > PRICE_ATOL or rerr > PRICE_ATOL:
            fail("sinkhorn", f"prices, {tag}: iterations {int(ic)} and {int(ih)}, price error "
                             f"{err}, residual error {rerr} (tolerance {PRICE_ATOL})")
        worst = max(worst, err, rerr)
        out.append({"case": tag, "iterations": int(ic), "residual": float(rc)})
    return {"cases": out, "max_abs_err": worst, "tolerance": PRICE_ATOL}


def _profile_windowed(torch, device, mode):
    """The first pipeline chunk of the 50k x 5k backlog (12,544 pods on
    its fresh node carry) solved once under torch.profiler
    (`utils.profiler.profile_call`): the host wall, the device time the
    trace holds, their ratio as the device's busy share, and the
    operations that hold most of the device time."""
    from kubernetes_tpu_torch import workload
    from kubernetes_tpu_torch.models.columnar import SnapshotBuilder
    from kubernetes_tpu_torch.ops.matrices import device_nodes, device_pods
    from kubernetes_tpu_torch.ops.pipeline import DEFAULT_CHUNK
    from kubernetes_tpu_torch.utils import profiler

    pending, nodes, services = workload.synthetic_objects(N_PODS, N_NODES, seed=2)
    builder = SnapshotBuilder(pending, nodes, (), services)
    carry = device_nodes(builder.node_columns(), device)
    pods = device_pods(builder.pod_columns(0, DEFAULT_CHUNK), device)
    (_, waves, _, _), prof = profiler.profile_call(lambda: _windowed_with_state(mode, pods, carry))
    return {
        "chunk_pods": DEFAULT_CHUNK, "waves": waves, **prof,
        "wall_ms_per_wave": prof["wall_ms"] / max(waves, 1),
        "timed": "host clock around one chunk's solve ending in a synchronise, under the profiler",
    }


def _windowed_card_vs_cpu(torch, device, mode, out):
    """The windowed solver on the card against the CPU on small clusters
    and on WINDOWED_CHECK (Sinkhorn's prices too), into `out`."""
    from kubernetes_tpu_torch import workload
    from kubernetes_tpu_torch.models.columnar import build_snapshot

    # The small clusters have assigned pods past their nodes' capacity:
    # the oracle's validity replay refuses a zero-request pod on such an
    # overcommitted node, which the reference's predicates (and the scan)
    # allow, so these are held card against CPU only; validity is checked
    # on the synthetic backlogs, which have no overcommitted node.
    for seed in range(8):
        pending, nodes, assigned, services = workload.small_cluster(seed)
        snap = build_snapshot(pending, nodes, assigned, services)
        for window in (32, 4096):
            out["card_vs_cpu"].append(_card_vs_cpu(torch, device, mode, f"small seed {seed}", snap,
                                                   window, validate=False))
    n_pods, n_nodes, seed = WINDOWED_CHECK
    pending, nodes, services = workload.synthetic_objects(n_pods, n_nodes, seed=seed)
    snap = build_snapshot(pending, nodes, services=services)
    out["card_vs_cpu"].append(_card_vs_cpu(torch, device, mode, f"{n_pods} x {n_nodes}", snap, 4096))
    if mode == "sinkhorn":
        out["prices"] = _prices_card_vs_cpu(torch, device, snap)


def _windowed_run(torch, device, mode, r):
    """Run `r` of the windowed mode on the 50k x 5k backlog (seed 2 + r):
    the pipeline timed by the host clock, then its placements held to
    the oracle's validity replay. Returns the run's record, its snapshot
    and its assignment."""
    from kubernetes_tpu_torch import workload
    from kubernetes_tpu_torch.models.columnar import build_snapshot
    from kubernetes_tpu_torch.ops import policy_scan, scan_kernel
    from kubernetes_tpu_torch.ops.pipeline import solve_backlog_pipelined
    from kubernetes_tpu_torch.utils.tracing import PhaseTimer

    pending, nodes, services = workload.synthetic_objects(N_PODS, N_NODES, seed=2 + r)
    timer = PhaseTimer()
    torch.cuda.synchronize()
    scan_kernel.scan_with_state.launches = policy_scan.policy_scan_with_state.launches = 0
    t0 = time.perf_counter()
    names = solve_backlog_pipelined(pending, nodes, services=services, mode=mode, device=device,
                                    timer=timer)
    wall = time.perf_counter() - t0
    hand = scan_kernel.scan_with_state.launches + policy_scan.policy_scan_with_state.launches
    if hand:
        fail(mode, f"the {mode} pipeline launched {hand} scan kernels")
    snap = build_snapshot(pending, nodes, services=services)
    assignment = _assignment_of(snap, names)
    _valid(mode, snap, assignment, f"50k run {r}")
    placed = int((assignment >= 0).sum())
    run = {"run": "warmup" if r == 0 else f"timed{r}", "seed": 2 + r, "wall_s": wall,
           "placed": placed, "pods_per_s": N_PODS / wall, "phases_s": timer.seconds,
           **timer.stats}
    return run, snap, assignment


def start_windowed(torch, device, modes, scan_placed):
    """Each windowed mode's warm-up run, its quality scored in a child
    process; the card-against-CPU cases while the children run; then the
    scores held to QUALITY. Returns each mode's partial line, so that
    its timed runs (run_windowed) start on a quiet host."""
    from kubernetes_tpu_torch.ops import oracle

    started = {}
    for mode in modes:
        run, snap, assignment = _windowed_run(torch, device, mode, 0)
        # Every pod the scan placed, as the quality gate's "placed".
        if run["placed"] < scan_placed:
            fail(mode, f"placed {run['placed']} pods of the backlog the scan placed {scan_placed} of")
        started[mode] = ({"card_vs_cpu": [], "runs": [run]},
                         cpu_check(oracle.assignment_quality, snap, assignment))
    for mode, (out, _) in started.items():
        _windowed_card_vs_cpu(torch, device, mode, out)
    for mode, (out, quality) in started.items():
        q, q["seconds"] = quality.result()
        bounds = QUALITY[mode]
        if (q["feasible_in_order"] < 0.99 or q["mean_regret"] > bounds["mean_regret"]
                or q["p99_regret"] > bounds["p99_regret"]
                or q["greedy_match"] < bounds["greedy_match"]):
            fail(mode, f"quality outside {bounds}: {q}")
        out["quality"] = {**q, "bounds": bounds, "scan_placed": scan_placed}
    return {mode: out for mode, (out, _) in started.items()}


def run_windowed(torch, device, mode, placed_names, out):
    """The windowed mode end to end after start_windowed's warm-up and
    checks (`out`): the timed runs, then the session's churn ticks."""
    from kubernetes_tpu_torch import workload
    from kubernetes_tpu_torch.ops import SolverSession

    runs = out.pop("runs")
    runs += [_windowed_run(torch, device, mode, r)[0] for r in range(1, MAIN_REPEATS + 1)]
    timed = [x["wall_s"] for x in runs[1:]]
    out.update(runs=runs, wall_s_median=statistics.median(timed),
               pods_per_s_median=N_PODS / statistics.median(timed), validity="100% (ops/oracle.py)")
    out["profile"] = _profile_windowed(torch, device, mode)

    nodes, services, assigned = _churn_cluster(placed_names)
    t0 = time.perf_counter()
    session = SolverSession(nodes, services, assigned, node_capacity=int(len(nodes) * 1.25),
                            mode=mode, device=device)
    build_s = time.perf_counter() - t0
    stats, rows = [], []

    def on_result(k, _results):
        stats.append(dict(session.last_stats))
        rows.append(_mirror_check(torch, session, f"{mode} session tick {k}"))

    records = workload.churn_replay(
        session, live=[f"default/{p.metadata.name}" for p in assigned], ticks=WINDOWED_TICKS,
        rate=CHURN_RATE, seed=7, n_services=len(services), first_index=N_PODS, on_result=on_result)
    out["session"] = {
        "session_build_s": build_s, "n_launch": session.n_launch,
        "ticks": [{"tick": k, "wall_s": rec.wall_s, "phases_s": rec.phases_s,
                   "placed": sum(d is not None for _k, d in rec.results), **stats[k],
                   "mirror_rows_checked": rows[k]} for k, rec in enumerate(records)],
    }
    if not all(t["placed"] for t in out["session"]["ticks"]):
        fail(mode, "a session tick placed no pod")
    return out


# ---------------------------------------------------------------------------
# Phases 5j-5m: preemption, the capacity report, the defrag plan (K2)
# ---------------------------------------------------------------------------

PREEMPT_NODES, PREEMPT_BOUND, PREEMPT_PREEMPTORS = 5000, 50000, 1000
PREEMPT_REPEATS = 2  # timed runs on seed 2 (3 before PR 17's cut)
PREEMPT_SMALL = 16  # seeded small problems held to the scalar rule
PREEMPT_MEDIUM = (200, 2000, 32)  # nodes, bound pods, preemptors held to the scalar rule
CAPACITY_REPEATS = 3  # 5 before PR 17's cut
REBALANCE_FORCED_NODES = 50
REBALANCE_CLUSTERS = (1, 2, 4, 8, 16)  # every cluster size K2's plan can choose
# (cluster, K, largest window; None: the plan's one row a warp)
REBALANCE_SWEEP = ((16, 1, None), (16, 4, None), (16, 16, None), (16, 32, None), (8, 8, None),
                   (4, 8, None), (16, 8, 2048))
REBALANCE_PLAIN_ROWS = 2048  # rows of case 2 held to the plain version on the card
REBALANCE_REPEATS = 2  # 3 before PR 17's cut


def _decisions(ds):
    return [(d.key, d.node, d.victims) if d else None for d in ds]


def run_preemption(torch, device):
    """Victim selection (plain PyTorch, no hand kernel) on a priority
    burst over a full fleet, held to its CPU run at full size and to the
    scalar rule on small and medium problems."""
    from kubernetes_tpu_torch import workload
    from kubernetes_tpu_torch.scheduler.batch import preempt_backlog, preempt_backlog_scalar
    from kubernetes_tpu_torch.utils.tracing import PhaseTimer

    # The scalar rule: 16 small seeded problems and one medium one.
    small_grants = 0
    for s in range(PREEMPT_SMALL):
        objs = workload.random_preemption_problem(s)
        card = _decisions(preempt_backlog(*objs, device=device))
        if card != _decisions(preempt_backlog_scalar(*objs)):
            fail("preemption", f"small problem {s}: the card differs from the scalar rule")
        if card != _decisions(preempt_backlog(*objs, device="cpu")):
            fail("preemption", f"small problem {s}: the card differs from the CPU")
        small_grants += sum(d is not None for d in card)
    objs = workload.preemption_objects(*PREEMPT_MEDIUM, seed=5)
    card = _decisions(preempt_backlog(*objs, device=device))
    t0 = time.perf_counter()
    scalar = _decisions(preempt_backlog_scalar(*objs))
    scalar_s = time.perf_counter() - t0
    if card != scalar:
        bad = sum(a != b for a, b in zip(card, scalar))
        fail("preemption", f"medium problem: {bad} decisions differ from the scalar rule")
    medium_grants = sum(d is not None for d in card)
    if medium_grants == 0:
        fail("preemption", "the medium problem granted nothing")

    # Full size: a warm-up and two timed runs on seed 2, one run on
    # seed 3; each seed's card decisions equal its CPU run's.
    out, objects_of = {}, {}
    for seed in (2, 3):
        t0 = time.perf_counter()
        objs = objects_of[seed] = workload.preemption_objects(
            PREEMPT_NODES, PREEMPT_BOUND, PREEMPT_PREEMPTORS, seed)
        make_s = time.perf_counter() - t0
        runs = []
        for r in range(PREEMPT_REPEATS + 1 if seed == 2 else 1):
            timer = PhaseTimer()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            card = _decisions(preempt_backlog(*objs, device=device, timer=timer))
            runs.append({"wall_s": time.perf_counter() - t0, "phases_s": dict(timer.seconds)})
        t0 = time.perf_counter()
        cpu = _decisions(preempt_backlog(*objs, device="cpu"))
        cpu_s = time.perf_counter() - t0
        if card != cpu:
            bad = sum(a != b for a, b in zip(card, cpu))
            fail("preemption", f"seed {seed}: {bad} decisions differ between the card and the CPU")
        grants = [d for d in card if d]
        if not grants:
            fail("preemption", f"seed {seed}: nothing granted")
        timed = runs[1:] if len(runs) > 1 else runs
        wall = statistics.median(r["wall_s"] for r in timed)
        out[f"seed{seed}"] = {
            "objects_s": make_s, "runs": runs, "wall_s_median": wall,
            "ms_per_preemptor": wall * 1e3 / PREEMPT_PREEMPTORS,
            "build_s_median": statistics.median(r["phases_s"]["build"] for r in timed),
            "solve_s_median": statistics.median(r["phases_s"]["solve"] for r in timed),
            "grants": len(grants), "victims": sum(len(d[2]) for d in grants),
            "nodes_used": len({d[1] for d in grants}),
            "cpu_run_s": cpu_s, "equal_to_cpu": True,
        }
    # One seed-2 solve under the profiler: the card's share of the solve.
    from kubernetes_tpu_torch.ops.preemption import build_preemption_problem, solve_preemption
    from kubernetes_tpu_torch.utils import profiler

    preemptors, nodes, assigned = objects_of[2]
    problem = build_preemption_problem(nodes, assigned)
    _, profiled = profiler.profile_call(lambda: solve_preemption(problem, preemptors, device=device))
    return {
        "cell": f"{PREEMPT_NODES} nodes, {PREEMPT_BOUND} bound pods at 85-100% of a resource, "
                f"{PREEMPT_PREEMPTORS} preemptors",
        **out,
        "solve_profiled": profiled,
        "scalar_checks": {"small_problems": PREEMPT_SMALL, "small_grants": small_grants,
                          "medium": list(PREEMPT_MEDIUM), "medium_grants": medium_grants,
                          "medium_scalar_s": scalar_s, "equal": True},
        "tolerance": "exact: node and victims in eviction order",
    }


def _capacity_equal(phase, tag, got, want):
    import numpy as np

    for i, (g, w) in enumerate(zip(got, want)):
        g = g.cpu().numpy() if hasattr(g, "cpu") else np.asarray(g)
        w = w.cpu().numpy() if hasattr(w, "cpu") else np.asarray(w)
        if g.shape != w.shape or g.dtype != w.dtype or not np.array_equal(g, w):
            fail(phase, f"{tag}: output {i} differs ({g.dtype} {g.shape} against {w.dtype} {w.shape})")


def run_capacity(torch, device, placed_names, session):
    """The capacity report (plain PyTorch) on the main path's placement
    and on the churn session's columns: card, CPU and the NumPy twin
    equal on every output; its median time."""
    from kubernetes_tpu_torch import workload
    from kubernetes_tpu_torch.ops.capacity import capacity_report, stage, _NODE_DTYPES, _PROBE_DTYPES
    from kubernetes_tpu_torch.ops.oracle import capacity_report_numpy
    from kubernetes_tpu_torch.utils import profiler
    from kubernetes_tpu_torch.utils.capacity import (
        COLUMN_KEYS, cluster_columns, probe_arrays, sample, session_columns)

    nodes, _services, assigned = _churn_cluster(placed_names)
    pending, _, _ = workload.synthetic_objects(N_PODS, N_NODES, seed=2)
    probes = workload.backlog_probes(pending)
    probe = probe_arrays(probes)
    out = {"probes": [list(p) for p in probes]}
    for tag, (cols, _names) in (("cluster", cluster_columns(nodes, assigned)),
                                ("session", session_columns(session))):
        args = tuple(cols[k] for k in COLUMN_KEYS) + tuple(probe)
        want = capacity_report_numpy(*args)
        card = sample(cols, probes, device=device)
        _capacity_equal("capacity", f"{tag} card against the twin", card, want)
        _capacity_equal("capacity", f"{tag} CPU against the twin",
                        capacity_report(*args, device="cpu"), want)
        walls, events = [], []
        staged = stage(args[:8], _NODE_DTYPES, device) + stage(args[8:], _PROBE_DTYPES, device)
        for _ in range(CAPACITY_REPEATS + 1):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            capacity_report(*args, device=device)[-1].item()
            walls.append((time.perf_counter() - t0) * 1e3)
            ev0, ev1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            ev0.record()
            capacity_report(*staged, device=device)
            ev1.record()
            torch.cuda.synchronize()
            events.append(ev0.elapsed_time(ev1))
        _, profiled = profiler.profile_call(lambda: capacity_report(*staged, device=device))
        out[tag] = {
            "nodes": int(args[0].shape[0]), "probes": int(args[8].shape[0]),
            "wall_ms_median": statistics.median(walls[1:]),
            "device_tensors_ms_median": statistics.median(events[1:]),
            "profiled": profiled,
            "frag_score": float(want[8]), "stranded_nodes": int(want[7].sum()),
            "headroom": [int(x) for x in want[4]], "equal": True,
        }
    out["timed"] = ("wall: host clock around capacity_report from the NumPy columns, staging and "
                    "one read included; device_tensors: CUDA events around it on staged tensors")
    return out


def _k2_vs_plain(torch, device, tag, args, plans=(None,)):
    """K2 at each of `plans` (None: the default plan) against its plain
    version on the card, on the same staged tensors: every output bit
    for bit. Returns the max abs error (0) and the plain outputs."""
    from kubernetes_tpu_torch.ops import rebalance
    from kubernetes_tpu_torch.ops.capacity import stage

    tensors = stage(args[:-1], rebalance._DTYPES, device)
    ref = rebalance.plan_moves_plain(*tensors, args[-1])
    err = 0.0
    for plan in plans:
        got = rebalance._launch(tensors, int(args[-1]), plan)
        torch.cuda.synchronize()
        for i, (g, r) in enumerate(zip(got, ref)):
            if g.dtype != r.dtype or g.shape != r.shape or not torch.equal(g, r):
                fail("rebalance_parity", f"{tag}, {plan}: output {i} differs from the plain version")
            if g.numel():
                err = max(err, float((g.double() - r.double()).abs().max()))
    return err, ref


def check_rebalance_parity(torch, device):
    """K2 held to its plain version on the card: every case at every
    cluster size the plan can choose (1, 2, 4, 8 and 16 CTAs), at the
    default K and at K = 1, resident and in place."""
    import numpy as np

    from kubernetes_tpu_torch import workload
    from kubernetes_tpu_torch.ops import rebalance

    cases = [(f"seed {s}", workload.random_rebalance_args(s)) for s in range(16)]
    cases.append(("consolidation", workload.consolidation_args()))
    empty = list(workload.random_rebalance_args(2))
    for k in range(8, 13):
        empty[k] = empty[k][:0]
    cases.append(("no rows", tuple(empty)))
    cases.append(("ties across warps, 5,000 nodes", workload.tied_rebalance_args(5000, 256, 256)))
    cases.append(("ties, 300 nodes", workload.tied_rebalance_args(300, 64, 64)))
    cases.append(("70 probes", workload.with_random_probes(workload.random_rebalance_args(4), 70)))
    err, checked, moves = 0.0, 0, 0
    rebalance.plan_moves.launches = 0
    for tag, args in cases:
        N, D, Q = (int(np.asarray(args[i]).shape[0]) for i in (0, 8, 13))
        plans = [rebalance.launch_plan(N, D, Q, cluster=c, k=k, resident=resident)
                 for c in REBALANCE_CLUSTERS for k in (None, 1) for resident in (True, False)]
        e, ref = _k2_vs_plain(torch, device, tag, args, plans)
        err = max(err, e)
        checked += len(plans)
        moves += int(ref[3])
    if moves == 0:
        fail("rebalance_parity", "no case committed a move")
    return {"cases": len(cases), "kernel_runs": checked, "launches": rebalance.plan_moves.launches,
            "clusters": list(REBALANCE_CLUSTERS), "k": [rebalance.DEFAULT_K, 1],
            "moves": moves, "max_abs_err": err,
            "tolerance": "exact (torch.equal on dest, moved, gain, n_moves and both scores)"}


def k2_bound(args, evaluated_rows):
    """The least time the card could take for one K2 launch on these
    inputs: `rebalance.cost` over the evaluated rows."""
    from kubernetes_tpu_torch.ops import rebalance

    N, D, Q = len(args[0]), len(args[8]), len(args[13])
    return _bound(rebalance.cost(N, D, Q, evaluated_rows), evaluated_rows=evaluated_rows)


def _evaluated_rows(pod_live, moved, n_moves, budget):
    """Rows K2 evaluates: the live rows up to the one that spends the
    budget (all live rows when it is never spent)."""
    import numpy as np

    if budget <= 0:
        return 0
    if int(n_moves) >= budget:
        last = int(np.nonzero(moved)[0][budget - 1])
        return int(pod_live[: last + 1].sum())
    return int(pod_live.sum())


def _k2_ms(torch, tensors, budget, reps=REBALANCE_REPEATS, plan=None):
    """Median CUDA-event milliseconds of `reps` K2 launches after a
    warm-up, all the times, and the last launch's stats (read here, off
    the timed launches)."""
    from kubernetes_tpu_torch.ops import rebalance

    times = []
    for _ in range(reps + 1):
        torch.cuda.synchronize()
        ev0, ev1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        ev0.record()
        rebalance._launch(tensors, budget, plan)
        ev1.record()
        torch.cuda.synchronize()
        times.append(ev0.elapsed_time(ev1))
    return statistics.median(times[1:]), times[1:], _k2_stats(rebalance.plan_moves.last_stats)


def _k2_stats(stats):
    """K2's stats tensor as a dict, with the screen's and the resolve's
    shares of CTA 0's cycles."""
    from kubernetes_tpu_torch.ops import rebalance

    out = dict(zip(rebalance.STATS, (int(v) for v in stats.cpu().tolist())))
    total = max(out["total_cycles"], 1)
    out["screen_share"] = out["screen_cycles"] / total
    out["resolve_share"] = out["resolve_cycles"] / total
    return out


def _rebalance_cases(placed_names):
    """The defrag plan's five worklists, as (tag, columns, node names,
    pods, probes, budget, forced nodes): the main path's placement, all
    50,000 pods movable, at budget 32 (the descheduler's), at budget D,
    with 50 forced (cordoned) nodes, and with every node forced (every
    row commits: the dense case); and a full fleet
    (preemption_objects(5000, 50000, 0, seed=2)) at budget D. The probes
    are the 50k backlog's."""
    from kubernetes_tpu_torch import workload
    from kubernetes_tpu_torch.utils.capacity import cluster_columns
    from kubernetes_tpu_torch.utils.rebalance import DEFAULT_MOVE_BUDGET, movable_pods

    nodes, _services, assigned = _churn_cluster(placed_names)
    cols, names = cluster_columns(nodes, assigned)
    pending, _, _ = workload.synthetic_objects(N_PODS, N_NODES, seed=2)
    probes = workload.backlog_probes(pending)
    D = len(assigned)
    forced = names[:: len(names) // REBALANCE_FORCED_NODES][:REBALANCE_FORCED_NODES]
    _, fleet_nodes, bound = workload.preemption_objects(N_NODES, N_PODS, 0, seed=2)
    fleet_cols, fleet_names = cluster_columns(fleet_nodes, bound)
    main = (cols, names, assigned, probes)
    return (("default_budget", *main, DEFAULT_MOVE_BUDGET, ()), ("budget_d", *main, D, ()),
            ("forced", *main, D, tuple(forced)), ("forced_all", *main, D, tuple(names)),
            ("full_fleet", fleet_cols, fleet_names, bound, probes, len(movable_pods(bound)), ()))


def run_rebalance(torch, device, placed_names):
    """build_plan on five worklists (the main path's placement at budget
    32, at budget D, with 50 and with every node forced; a full fleet),
    each held in full to the NumPy twin (run in child processes); K2
    timed by CUDA events with its
    commits, windows, rows screened and screen/resolve split, and held to
    its plain version on the first rows of budget D; K2 swept over the
    cluster size, K and the largest window."""
    import numpy as np

    from kubernetes_tpu_torch.ops import rebalance
    from kubernetes_tpu_torch.ops.capacity import stage
    from kubernetes_tpu_torch.ops.oracle import plan_moves_numpy
    from kubernetes_tpu_torch.utils.capacity import COLUMN_KEYS, probe_arrays
    from kubernetes_tpu_torch.utils.rebalance import (
        build_plan, group_plan, stage_rows)
    from kubernetes_tpu_torch.utils.tracing import PhaseTimer

    cases = _rebalance_cases(placed_names)
    out = {"cell": f"{N_NODES} nodes, {N_PODS} movable pods (main path's placement) or "
                   f"{len(cases[-1][3])} (full fleet), {len(cases[0][4])} probes",
           "probes": [list(p) for p in cases[0][4]]}
    # Each plan's wall first, with nothing else running on the host; then
    # the NumPy twins in child processes while K2's outputs are read here
    # (untimed); K2 is timed once the twins have ended.
    launches, staged, plans = {}, {}, {}
    for tag, cols, names, pods, probes, budget, forced_nodes in cases:
        timer = PhaseTimer()
        rebalance.plan_moves.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        plan = build_plan(cols, names, pods, probes, budget, forced_nodes, device=device,
                          timer=timer)
        wall = time.perf_counter() - t0
        launches[tag] = rebalance.plan_moves.launches
        if launches[tag] != 1:
            fail("rebalance", f"{tag}: build_plan launched K2 {launches[tag]} times, not once")
        plans[tag] = (plan, wall, timer)
    twins = {}
    for tag, cols, names, pods, probes, budget, forced_nodes in cases:
        rows, *row_arrays = stage_rows(cols, names, pods, forced_nodes)
        args = tuple(cols[k] for k in COLUMN_KEYS) + tuple(row_arrays) + tuple(
            probe_arrays(probes)) + (np.int32(budget),)
        twins[tag] = (cpu_check(plan_moves_numpy, *args), rows, row_arrays)
        staged[tag] = (args, stage(args[:-1], rebalance._DTYPES, device))
    k2_out = {c[0]: [t.cpu().numpy() for t in rebalance._launch(staged[c[0]][1], c[5])]
              for c in cases}
    checked = {}
    for tag, cols, names, pods, probes, budget, forced_nodes in cases:
        future, rows, row_arrays = twins[tag]
        twin, twin_s = future.result()
        for i, (g, w) in enumerate(zip(k2_out[tag], twin)):
            w = np.asarray(w)
            if g.shape != w.shape or g.dtype != w.dtype or not np.array_equal(g, w):
                fail("rebalance", f"{tag}: K2's output {i} differs from the NumPy twin")
        if plans[tag][0] != group_plan(rows, names, row_arrays[4], *twin[:3], budget, twin[4],
                                       twin[5]):
            fail("rebalance", f"{tag}: the plan differs from the plan of the twin's rows")
        checked[tag] = {"score_before": float(twin[4]), "score_after": float(twin[5]),
                        "twin_s": twin_s, "equal_to_twin": True}
    for tag, cols, names, pods, probes, budget, forced_nodes in cases:
        args, tensors = staged[tag]
        plan, wall, timer = plans[tag]
        k2 = k2_out[tag]
        ms, ms_all, stats = _k2_ms(torch, tensors, budget)
        evaluated = _evaluated_rows(twins[tag][2][3], k2[1], k2[3], budget)
        out[tag] = {
            "budget": budget, "forced_nodes": len(forced_nodes), "rows": len(twins[tag][1]),
            "wall_s": wall, "phases_s": dict(timer.seconds), "k2_ms": ms, "k2_ms_all": ms_all,
            "evaluated_rows": evaluated, "us_per_row": ms * 1e3 / max(evaluated, 1),
            "n_moves": int(k2[3]), "planned_moves": len(plan["moves"]) if plan else 0,
            "stats": stats, "bound": k2_bound(args, evaluated), **checked[tag],
        }
    if (out["forced"]["n_moves"] == 0 or out["forced_all"]["n_moves"] == 0
            or any(out[c[0]]["n_moves"] > c[5] for c in cases)):
        fail("rebalance", "a forced drain moved nothing, or a case moved past its budget")
    full_args, full_tensors = staged["budget_d"]

    # K2 against its plain version on the card, the first rows of case 2:
    # both timed, and bounded, on those rows.
    prefix = tuple(a[:REBALANCE_PLAIN_ROWS] if 8 <= k < 13 else a for k, a in enumerate(full_args))
    err, ref = _k2_vs_plain(torch, device, f"first {REBALANCE_PLAIN_ROWS} rows of budget D", prefix)
    pt = stage(prefix[:-1], rebalance._DTYPES, device)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rebalance.plan_moves_plain(*pt, prefix[-1])[-1].item()
    plain_ms = (time.perf_counter() - t0) * 1e3
    ms_prefix, _, _ = _k2_ms(torch, pt, int(prefix[-1]))
    bound = k2_bound(prefix, _evaluated_rows(prefix[11], ref[1].cpu().numpy(), ref[3], int(prefix[-1])))
    lp = rebalance.launch_plan(len(full_args[0]), len(full_args[8]), len(full_args[13]))

    # Where a row's time goes: budget D's rows against the first n nodes
    # (sources past n read as none); and the cluster size, K and the
    # largest window swept on budget D, 50 forced nodes and the full
    # fleet, each run's outputs equal to the default plan's.
    rows_d = out["budget_d"]["evaluated_rows"]
    by_nodes = {}
    for n in (256, 1024, 2048):
        cut = tuple(a[:n] if k < 8 else a for k, a in enumerate(full_args))
        t, _, _ = _k2_ms(torch, stage(cut[:-1], rebalance._DTYPES, device), int(cut[-1]), 1)
        by_nodes[n] = t * 1e3 / rows_d
    by_nodes[len(full_args[0])] = out["budget_d"]["us_per_row"]
    sweep = []
    for tag in ("budget_d", "forced", "full_fleet"):
        args, tensors = staged[tag]
        want = [t.cpu() for t in rebalance._launch(tensors, int(args[-1]))]
        for cluster, k, max_rows in REBALANCE_SWEEP:
            cfg = rebalance.launch_plan(len(args[0]), len(args[8]), len(args[13]), cluster=cluster,
                                        k=k, max_rows=max_rows)
            got = [t.cpu() for t in rebalance._launch(tensors, int(args[-1]), cfg)]
            if any(not torch.equal(g, w) for g, w in zip(got, want)):
                fail("rebalance", f"{tag}: K2 on {cluster} CTAs at K = {k}, windows to "
                                  f"{cfg.max_rows} differs")
            ms, _, stats = _k2_ms(torch, tensors, int(args[-1]), 1, cfg)
            sweep.append({"worklist": tag, "cluster": cluster, "k": k, "max_rows": cfg.max_rows,
                          "ms": ms, "us_per_row": ms * 1e3 / out[tag]["evaluated_rows"],
                          "stats": stats})
    out["k2"] = {
        "plan": {"cluster": lp.cluster, "threads": lp.threads, "k": lp.k,
                 "first_rows": lp.first_rows, "max_rows": lp.max_rows, "resident": lp.resident,
                 "smem_bytes": lp.smem_bytes, "scratch_bytes": lp.scratch_bytes},
        "rows": REBALANCE_PLAIN_ROWS, "ms": ms_prefix, "plain_ms": plain_ms, "max_abs_err": err,
        **bound,
        "worklist_ms": out["budget_d"]["k2_ms"], "us_per_row": out["budget_d"]["us_per_row"],
        "worklist": out["budget_d"]["bound"],
        "worklists": {c[0]: {"ms": out[c[0]]["k2_ms"], "us_per_row": out[c[0]]["us_per_row"],
                             "bound_ms": out[c[0]]["bound"]["bound_ms"],
                             "commits": out[c[0]]["n_moves"],
                             "windows": out[c[0]]["stats"]["windows"],
                             "rows_screened": out[c[0]]["stats"]["rows_screened"],
                             "screen_share": out[c[0]]["stats"]["screen_share"],
                             "resolve_share": out[c[0]]["stats"]["resolve_share"]}
                      for c in cases},
        "us_per_row_by_nodes": by_nodes, "sweep": sweep,
        "timed": "ms: CUDA events around the wrapper's launch on the first `rows` rows of case "
                 "budget_d; plain_ms: host clock around the plain loop on the same rows, ending in "
                 "a read; worklist_ms and worklists: CUDA events around the launch on each whole "
                 "worklist; shares: of CTA 0's clock64 cycles (kernel stats)",
    }
    out["launches"] = launches
    return out


# ---------------------------------------------------------------------------
# Phase 5n: the telemetry plane
# ---------------------------------------------------------------------------

LEDGER_TOP_SHAPES = 4  # shape rows printed a ledger row, by calls
TELEMETRY_PROFILED_RUNS = 2  # default backlog runs under torch.profiler


def run_telemetry(torch, device, main_result, churn, first_names):
    """The kernel ledger's rows; default backlog runs under torch.profiler
    with their transfer bytes (h2d, d2h) and the card's busy share, and
    one with CUDA events around each K1 launch (K1's busy share); device
    memory after the main path; the churn ticks' duty cycle and overlap,
    and the profiled churn tick's busy share; the build pair and a few
    series as the registry holds them."""
    from kubernetes_tpu_torch import workload
    from kubernetes_tpu_torch.ops import ledger
    from kubernetes_tpu_torch.ops.matrices import _pod_axis_bucket
    from kubernetes_tpu_torch.ops.pipeline import DEFAULT_CHUNK, solve_backlog_pipelined
    from kubernetes_tpu_torch.utils import capacity, metrics, profiler, rebalance, sli, tracing

    pending, nodes, services = workload.synthetic_objects(N_PODS, N_NODES, seed=2)
    profiled = []
    for _ in range(TELEMETRY_PROFILED_RUNS):
        before = {d: sli.TRANSFER_BYTES.value(direction=d) for d in ("h2d", "d2h")}
        calls0 = ledger.DEFAULT.calls("scan_kernel")
        names, prof = profiler.profile_call(
            lambda: solve_backlog_pipelined(pending, nodes, services=services, device=device))
        moved = {d: sli.TRANSFER_BYTES.value(direction=d) - before[d] for d in before}
        if names != first_names:
            fail("telemetry", "the profiled backlog run disagrees with the main path's first run")
        # The busy share holds only when the trace saw every launch the
        # ledger counted.
        seen = sum(k["calls"] for k in prof["top_kernels"] if "scan_kernel" in k["kernel"])
        launched = ledger.DEFAULT.calls("scan_kernel") - calls0
        prof.update(scan_kernel_launched=launched, scan_kernel_in_trace=seen,
                    trace_complete=seen == launched)
        profiled.append(prof)
    chunks = [min(DEFAULT_CHUNK, N_PODS - s) for s in range(0, N_PODS, DEFAULT_CHUNK)]
    k1_events = _k1_events_run(torch, device, (pending, nodes, services), first_names, len(chunks))
    want_d2h = 4 * sum(_pod_axis_bucket(c, 128) for c in chunks)
    if moved["d2h"] != want_d2h or moved["h2d"] <= 0:
        fail("telemetry", f"the backlog moved {moved}, expected d2h {want_d2h} and some h2d")

    rows = ledger.DEFAULT.rows()
    for kernel in ("scan_kernel", "policy_scan_kernel", "rebalance_kernel"):
        row = next((r for r in rows if (r["kernel"], r["impl"]) == (kernel, "cuda")), None)
        if row is None or row["calls"] == 0 or not all(
                x.get("cost_status") == "ok" and x["bytes_accessed"] > 0 for x in row["shapes"]):
            fail("telemetry", f"the kernel ledger has no launches or no cost rows for {kernel}")
    sli.observe_device_telemetry()

    def hist(h, **labels):
        return {"count": h.count(**labels), "p50": h.quantile(0.5, **labels),
                "p99": h.quantile(0.99, **labels)}

    return {
        "ledger": [
            {**{k: r[k] for k in ("kernel", "impl", "calls", "compiles", "compile_seconds")},
             "shapes": len(r["shapes"]),
             "top_shapes": [{k: x.get(k) for k in ("signature", "calls", "flops", "bytes_accessed",
                                                   "arithmetic_intensity")}
                            for x in sorted(r["shapes"], key=lambda x: -x["calls"])[:LEDGER_TOP_SHAPES]]}
            for r in rows
        ],
        "ledger_summary": ledger.DEFAULT.summary(rows),
        "backlog_transfer_bytes": moved,
        "backlog_profiled": profiled,
        "backlog_k1_events": k1_events,
        "device_memory_after_main": main_result["device_memory_bytes"],
        "churn_duty": {"synchronous": churn["duty"], "pipelined": churn["pipelined"]["duty"]},
        "churn_tick_profiled": churn["profiled_tick"],
        "series": {
            "scheduler_device_duty_cycle": hist(profiler.DUTY_CYCLE),
            "scheduler_overlap_efficiency": hist(profiler.OVERLAP),
            "scheduler_device_busy_seconds_total": profiler.DEVICE_BUSY.value(),
            "scheduler_phase_seconds": {p[0]: hist(tracing.PHASE_SECONDS, phase=p[0])
                                        for p in tracing.PHASE_SECONDS.label_values()},
            "solver_device_transfer_bytes_total": {d: sli.TRANSFER_BYTES.value(direction=d)
                                                   for d in ("h2d", "d2h")},
            "solver_xla_compile_cache_entries": sli.XLA_CACHE_ENTRIES.value(),
            "solver_xla_compiles_total": sli.XLA_COMPILES.value(),
            "device_memory_bytes": {k: sli.DEVICE_MEMORY.value(kind=k)
                                    for k in ("in_use", "peak", "limit")},
            "cluster_fragmentation_score": hist(capacity.FRAG_SCORE),
            "rebalance_moves_total": {"planned": rebalance.MOVES.value(outcome="planned")},
            "registered": len(metrics.DEFAULT.all()),
        },
        "timed": "backlog_profiled: solve_backlog_pipelined (seed 2) under torch.profiler, "
                 "busy share = the kernels' own device time in the trace over the host wall "
                 "(it holds only when trace_complete: the trace saw every K1 launch the "
                 "ledger counted); backlog_k1_events: one more such run, CUDA events around "
                 "each K1 launch, K1's share of the host wall; transfer bytes: the last "
                 "profiled run",
    }


def _k1_events_run(torch, device, objs, first_names, chunks):
    """solve_backlog_pipelined once with CUDA events recorded around each
    K1 launch: each launch's device ms, their sum over the host wall (the
    card's busy share from K1 alone, read without the profiler), and the
    collector's passes during the run."""
    from kubernetes_tpu_torch.ops.pipeline import solve_backlog_pipelined

    pending, nodes, services = objs
    torch.cuda.synchronize()
    with _K1Events(torch) as k1, GcPauses() as pauses:
        t0 = time.perf_counter()
        names = solve_backlog_pipelined(pending, nodes, services=services, device=device)
        wall_ms = (time.perf_counter() - t0) * 1e3
    if names != first_names:
        fail("telemetry", "the K1-timed backlog run disagrees with the main path's first run")
    k1_ms = [a.elapsed_time(b) for a, b in k1.events]
    if len(k1_ms) != chunks:
        fail("telemetry", f"the K1-timed backlog run launched K1 {len(k1_ms)} times, not {chunks}")
    return {"wall_ms": wall_ms, "k1_ms": k1_ms, "k1_busy_share": sum(k1_ms) / wall_ms,
            "gc": pauses.summary()}


# ---------------------------------------------------------------------------
# Phase 5o: the scheduler daemon against the port's apiserver
# ---------------------------------------------------------------------------

DAEMON_NODES = 5000
DAEMON_PARITY_PODS = 1024
DAEMON_SELECTOR_EVERY = 8  # every eighth parity pod carries a nodeSelector
# daemon_parity_wide: every node carries its hostname label (5,004 label
# tokens) and every tenth pod mounts a disk of its own (103 volumes);
# the session's vocabularies are sized from them, its pod rows 224
# words, the most K1's two 128-pod tiles hold.
DAEMON_VOLUME_EVERY = 10
# daemon_parity_hostnames: 8,000 nodes with their hostname labels, past
# what two 128-pod tiles of K1's pod rows hold.
HOSTNAME_NODES = 8000
DRILL_RATE = 1000  # creates a second, and deletes a second
DRILL_CREATORS = 2
DRILL_WARMUP_S = 2.0  # 6 s before PR 17's cut
DRILL_WINDOW_S = 6.0  # 10 s before PR 17's cut
DRILL_DRAIN_S = 10.0  # the window's pods' time to bind, for the latencies
DRILL_LOST_S = 30.0  # after the window: a pod still unbound then is lost
DRILL_CUSHION = 200  # bound pods the drill's deleter leaves alone
CHURN_PRELOAD = 50000  # BASELINE config 5's pods, bound round-robin before the daemon starts
PRELOAD_BATCH = 5000
APISERVER_UP_S = 30.0
APISERVER_INFLIGHT = 800


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _cuda_context_of(pid):
    """Whether process `pid` holds a CUDA context: listed by `nvidia-smi
    --query-compute-apps`, or libcuda mapped in its memory.
    Returns (holds, how it was read)."""
    listed = None
    try:
        out = subprocess.run(["nvidia-smi", "--query-compute-apps=pid", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30).stdout
        listed = [int(x) for x in out.split() if x.strip().isdigit()]
    except (OSError, subprocess.SubprocessError):
        pass
    try:
        with open(f"/proc/{pid}/maps") as f:
            mapped = "libcuda.so" in f.read()
    except OSError:
        mapped = None
    return (bool(listed and pid in listed) or bool(mapped),
            {"compute_apps": listed, "libcuda_mapped": mapped})


def _log_tail(log, n):
    """The last `n` characters of a child's output file. Read with
    `os.pread`: the child writes through the same open file, so a seek
    here would move its write offset and its next line would overwrite
    the start of the file."""
    fd = log.fileno()
    return os.pread(fd, os.fstat(fd).st_size, 0).decode(errors="replace")[-n:]


class ControlPlane:
    """The port's apiserver as a child process (`python -m
    kubernetes_tpu_torch.cmd.hyperkube apiserver`, store in memory
    unless `data_dir` is given, then durable with the command's default
    fsync): the cluster's control plane, which the
    port's scheduler reaches over HTTP like any client. Nothing of it is
    imported here. Up when /healthz answers (at most APISERVER_UP_S),
    and then the phase fails if the child holds a CUDA context (the
    apiserver is host code); stopped with its whole process group.
    `kill()` SIGKILLs it, and `restart()` starts it again on the same
    port and flags. Subclasses start other host-only children the same
    way (`ControllerManagerChild`, `ReplicaChild`); one whose command
    reads the card (`CloudManagerChild`) sets `host_only` False."""

    what = "apiserver"
    host_only = True

    def __init__(self, phase, data_dir=None):
        self.phase = phase
        self.port = _free_port()
        self.url = f"http://127.0.0.1:{self.port}"
        self.cmd = [sys.executable, "-m", "kubernetes_tpu_torch.cmd.hyperkube", "apiserver",
                    "--port", str(self.port), "--max-requests-inflight", str(APISERVER_INFLIGHT)]
        if data_dir:
            self.cmd += ["--data-dir", data_dir]
        self._spawn()

    def _spawn(self):
        import tempfile

        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(p for p in (REPO, env.get("PYTHONPATH")) if p)
        self._log = tempfile.TemporaryFile()
        self.proc = subprocess.Popen(self.cmd, cwd=REPO, env=env, stdin=subprocess.DEVNULL,
                                     stdout=self._log, stderr=subprocess.STDOUT,
                                     start_new_session=True)

    def __enter__(self):
        import http.client

        deadline = time.monotonic() + APISERVER_UP_S
        while True:
            if self.proc.poll() is not None:
                self.stop()
                fail(self.phase, f"the {self.what} exited with {self.proc.returncode}: "
                                 f"{self.tail()}")
            try:
                conn = http.client.HTTPConnection("127.0.0.1", self.port, timeout=2)
                conn.request("GET", "/healthz")
                if conn.getresponse().status == 200:
                    conn.close()
                    self.cuda_context, self.cuda_probe = _cuda_context_of(self.proc.pid)
                    if self.cuda_context and self.host_only:
                        self.stop()
                        fail(self.phase, f"the {self.what} child (pid {self.proc.pid}) holds a "
                                         f"CUDA context: {self.cuda_probe}")
                    return self
                conn.close()
            except OSError:
                pass
            if time.monotonic() > deadline:
                self.stop()
                fail(self.phase, f"the {self.what} did not answer /healthz in {APISERVER_UP_S} s: "
                                 f"{self.tail()}")
            time.sleep(0.1)

    def __exit__(self, *exc):
        self.stop()

    def kill(self):
        """SIGKILL the child's process group and reap it."""
        import signal

        try:
            os.killpg(self.proc.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
        self.proc.wait(timeout=10)

    def restart(self):
        """Start the child again with the same command; returns once it
        answers /healthz."""
        self._spawn()
        return self.__enter__()

    def tail(self, n=2000):
        return _log_tail(self._log, n)

    def cpu_seconds(self):
        """User + system seconds of the child so far (/proc/<pid>/stat)."""
        with open(f"/proc/{self.proc.pid}/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        return (int(fields[11]) + int(fields[12])) / os.sysconf("SC_CLK_TCK")

    def stop(self):
        import signal

        if self.proc.poll() is None:
            try:
                os.killpg(self.proc.pid, signal.SIGTERM)
                self.proc.wait(timeout=10)
            except (ProcessLookupError, subprocess.TimeoutExpired):
                try:
                    os.killpg(self.proc.pid, signal.SIGKILL)
                except ProcessLookupError:
                    pass
                self.proc.wait(timeout=10)


def _daemon_node_wire(j, hostname=False):
    """bench.py's churn node (8/16/32 cpus, 16/32/64 Gi, 110 pods), with
    a zone label for the parity leg's selectors and, with `hostname`,
    the hostname label every kubelet-registered node carries."""
    labels = {"zone": f"z{j % 4}"}
    if hostname:
        labels["kubernetes.io/hostname"] = f"n{j}"
    return {"kind": "Node",
            "metadata": {"name": f"n{j}", "labels": labels},
            "status": {"capacity": {"cpu": str((8, 16, 32)[j % 3]),
                                    "memory": f"{(16, 32, 64)[j % 3]}Gi", "pods": "110"},
                       "conditions": [{"type": "Ready", "status": "True"}]}}


def _daemon_pod_wire(name, zone=None, selector=None, disk=None):
    """bench.py's churn pod: cpu 100/250/500m and memory 64/128/256Mi
    by the name's crc32, so every process makes the same pod; `zone` or
    `selector` gives it a nodeSelector, `disk` a GCE PD mounted
    read-write."""
    import zlib

    h = zlib.crc32(name.encode())
    spec = {"containers": [{"name": "c", "image": "app", "resources": {"limits": {
        "cpu": f"{(100, 250, 500)[h % 3]}m", "memory": f"{(64, 128, 256)[h // 3 % 3]}Mi"}}}]}
    if zone is not None:
        spec["nodeSelector"] = {"zone": zone}
    if selector is not None:
        spec["nodeSelector"] = selector
    if disk is not None:
        spec["volumes"] = [{"name": "data", "gcePersistentDisk": {"pdName": disk}}]
    return {"kind": "Pod", "metadata": {"name": name, "namespace": "default"}, "spec": spec}


def _bulk(phase, call, items, batch=PRELOAD_BATCH, **kw):
    """A bulk verb over `items` in batches; every item must succeed."""
    for s in range(0, len(items), batch):
        results = call(items[s:s + batch], **kw)
        bad = [r for r in results if r.get("status") != "Success"]
        if len(results) != len(items[s:s + batch]) or bad:
            fail(phase, f"bulk call failed on {len(bad)} items: {bad[:2]}")


def _cluster(phase, client, pods=0, hostname=False, n_nodes=DAEMON_NODES):
    """The drill's nodes and, with `pods`, that many pods bound round-robin
    (pod i on node i mod DAEMON_NODES). Returns the pods' names."""
    _bulk(phase, lambda xs: client.create_bulk("nodes", xs),
          [_daemon_node_wire(j, hostname) for j in range(n_nodes)])
    names = [f"pre{i}" for i in range(pods)]
    _bulk(phase, lambda xs: client.create_bulk("pods", xs, namespace="default"),
          [_daemon_pod_wire(n) for n in names])
    _bulk(phase, lambda xs: client.bind_bulk(xs, namespace="default"),
          [(n, f"n{i % DAEMON_NODES}") for i, n in enumerate(names)])
    return names


def _wait(phase, what, cond, timeout=30.0, interval=0.05):
    """Seconds until `cond()` holds, polled every `interval`; fails the
    phase after `timeout`."""
    t0 = time.monotonic()
    while not cond():
        if time.monotonic() - t0 > timeout:
            fail(phase, f"timed out waiting for {what}")
        time.sleep(interval)
    return time.monotonic() - t0


def _listed(client):
    """(pod name -> node name or None, typed pods, typed nodes) by LIST."""
    pods, _ = client.list("pods", namespace="default")
    nodes, _ = client.list("nodes")
    return {p.metadata.name: p.spec.node_name or None for p in pods}, pods, nodes


def _plain_session(torch, device, nodes, assigned=(), pending=()):
    """A session as the daemon builds one (vocabularies sized over the
    nodes and pods), with K1's plain version in place of the kernel."""
    from kubernetes_tpu_torch.ops import SolverSession, scan_kernel
    from kubernetes_tpu_torch.ops.incremental import vocab_widths

    lw, pw, vw = vocab_widths(nodes, [*assigned, *pending])
    session = SolverSession(nodes, assigned=assigned, node_capacity=max(64, int(len(nodes) * 1.25)),
                            label_words=lw, port_words=pw, vol_words=vw, device=device)
    session._dispatch = lambda pods, carry: (
        scan_kernel.plain_scan_with_state(pods, carry, (1, 1, 1))[0], (None, None, None))
    return session


def _parity_pod(i, wide, n_nodes=DAEMON_NODES):
    """Parity pod i: every eighth selects a zone or, `wide`, a host;
    `wide`, every tenth mounts a disk of its own."""
    sel = i % DAEMON_SELECTOR_EVERY == 0
    if not wide:
        return _daemon_pod_wire(f"d{i}", f"z{(i // DAEMON_SELECTOR_EVERY) % 4}" if sel else None)
    return _daemon_pod_wire(
        f"d{i}", selector={"kubernetes.io/hostname": f"n{i * 37 % n_nodes}"} if sel else None,
        disk=f"pd-{i}" if i % DAEMON_VOLUME_EVERY == 3 else None)


def _policy_cluster(phase, client, n_pending, seed=5):
    """`workload.policy_objects(n_pending, DAEMON_NODES, seed)` in the
    apiserver: the labelled nodes (rack, ssd, retiring, some without a
    zone), its services, its peers created and bound to their nodes.
    Returns the pending pods' wire forms, not created."""
    from kubernetes_tpu_torch import workload
    from kubernetes_tpu_torch.models import serde

    pending, nodes, assigned, services = workload.policy_objects(n_pending, DAEMON_NODES, seed)
    _bulk(phase, lambda xs: client.create_bulk("nodes", xs), [serde.to_wire(n) for n in nodes])
    for svc in services:
        wire = serde.to_wire(svc)
        wire["spec"].setdefault("ports", [{"port": 80}])  # the apiserver requires one
        client.create("services", wire, namespace="default")
    peers = []
    for pod in assigned:
        wire = serde.to_wire(pod)
        wire["spec"].pop("nodeName", None)
        wire.pop("status", None)
        peers.append(wire)
    _bulk(phase, lambda xs: client.create_bulk("pods", xs, namespace="default"), peers)
    _bulk(phase, lambda xs: client.bind_bulk(xs, namespace="default"),
          [(p.metadata.name, p.spec.node_name) for p in assigned])
    wires = []
    for pod in pending:
        wire = serde.to_wire(pod)
        wire.pop("status", None)
        wires.append(wire)
    return wires


def _capacity_vs_plain(phase, daemon, pending):
    """The capacity monitor's snapshot after the daemon's tick against
    the plain version's report (a fresh monitor on the CPU) on the same
    session columns and probes, every field but the backlog's age and
    pressure (the wall clock's)."""
    from kubernetes_tpu_torch.models.columnar import mem_to_mib_ceil, pod_resource_limits
    from kubernetes_tpu_torch.utils import capacity

    got = capacity.DEFAULT.snapshot()
    ref = capacity.CapacityMonitor()
    ref.note_backlog_shapes([(float(c), float(mem_to_mib_ceil(m)))
                             for c, m in map(pod_resource_limits, pending)])
    cols, names = capacity.session_columns(daemon._session)
    t0 = time.perf_counter()
    want = ref.sample(cols, names, backlog_depth=got.get("backlog", {}).get("depth", 0),
                      device="cpu")
    plain_s = time.perf_counter() - t0
    got_b, want_b = got.pop("backlog", None), want.pop("backlog")
    if got != want or got_b is None or got_b["depth"] != want_b["depth"]:
        diff = sorted(k for k in set(got) | set(want) if got.get(k) != want.get(k))
        fail(phase, f"the capacity snapshot differs from the plain report in {diff}")
    return {"equal_to_plain": True, "samples": got["samples"], "score": got["fragmentation_score"],
            "live_nodes": got["live_nodes"], "probes": len(got["probes"]), "plain_s": plain_s}


EXPLAIN_LIMIT = 64  # the JAX default: pods a tick with verdict tables


def _fresh_recorder():
    """The flight recorder's ring emptied, at the JAX defaults (explain
    limit 64, every trace sampled)."""
    from kubernetes_tpu_torch.utils import flightrecorder, tracing

    flightrecorder.configure(ring=4096, solve_ring=512, explain_top_k=3, explain_failed_nodes=16,
                             explain_limit=EXPLAIN_LIMIT)
    flightrecorder.DEFAULT.clear()
    flightrecorder.take_last_solve_telemetry()
    tracing.configure(sample_rate=1.0)


class _RecordTimer:
    """Host seconds of a daemon's flight recording: `_record_decisions`
    (the rows, sinks, ring and the inline explain) and `_attach_verdicts`
    by pass (inline: every pod or the unbound ones; deferred: the bound
    ones, on the commit worker's idle drain), and within the passes the
    `explain_backlog` calls (the lowering, the card's readback and the
    tables; the rest is the pod lister's read). `record_s` is the first
    less the inline explain. `close()` puts `explain_backlog` back."""

    def __init__(self, daemon):
        import threading

        from kubernetes_tpu_torch.scheduler import daemon as daemon_mod

        self.lock = threading.Lock()
        self.totals = {"record_s": 0.0, "records": 0, "inline_explain_s": 0.0,
                       "deferred_explain_s": 0.0, "deferred_explains": 0,
                       "explain_backlog_s": 0.0}
        record, attach = daemon._record_decisions, daemon._attach_verdicts
        self._module, self._explain = daemon_mod, daemon_mod.explain_backlog

        def timed_explain(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return self._explain(*args, **kwargs)
            finally:
                self._add(explain_backlog_s=time.perf_counter() - t0)

        daemon_mod.explain_backlog = timed_explain

        def timed_record(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return record(*args, **kwargs)
            finally:
                self._add(record_s=time.perf_counter() - t0, records=1)

        def timed_attach(*args, only=None, **kwargs):
            t0 = time.perf_counter()
            try:
                return attach(*args, only=only, **kwargs)
            finally:
                dt = time.perf_counter() - t0
                if only == "bound":
                    self._add(deferred_explain_s=dt, deferred_explains=1)
                else:
                    self._add(inline_explain_s=dt)

        daemon._record_decisions, daemon._attach_verdicts = timed_record, timed_attach

    def close(self):
        self._module.explain_backlog = self._explain

    def _add(self, **kw):
        with self.lock:
            for k, v in kw.items():
                self.totals[k] += v

    def snapshot(self):
        with self.lock:
            return dict(self.totals)

    @staticmethod
    def between(a, b, ticks):
        """The figures between two snapshots, a tick where `ticks`."""
        d = {k: b[k] - a[k] for k in a}
        own = d["record_s"] - d["inline_explain_s"]
        return {"records": d["records"], "record_s": own,
                "record_s_per_tick": own / ticks if ticks else None,
                "inline_explain_s": d["inline_explain_s"],
                "deferred_explain_s": d["deferred_explain_s"],
                "deferred_explains": d["deferred_explains"],
                "explain_backlog_s": d["explain_backlog_s"]}


def _newest_decisions():
    """Pod key -> its newest decision in the daemon's ring."""
    from kubernetes_tpu_torch.utils import flightrecorder

    out = {}
    for d in flightrecorder.DEFAULT.decisions(limit=1 << 30)["decisions"]:
        out.setdefault(d["pod"], d)
    return out


def _explain_vs_cpu(phase, pending, bindings, nodes, services):
    """The verdict tables of the tick's first EXPLAIN_LIMIT pods (unbound
    first, then bound, in the tick's order, as `_attach_verdicts` takes
    them) against the port's `explain_backlog` on the CPU: bound pods
    against the occupancy before the tick (no bound pod), unbound ones
    against the one after it (every pod the tick bound), exactly."""
    import copy

    from kubernetes_tpu_torch.ops.pipeline import explain_backlog
    from kubernetes_tpu_torch.utils import flightrecorder

    ring = list(reversed(flightrecorder.DEFAULT.decisions(limit=1 << 30)["decisions"]))
    if len(ring) != len(pending) or len({d["tick"] for d in ring}) != 1:
        fail(phase, f"{len(ring)} decisions in {len({d['tick'] for d in ring})} ticks for "
                    f"{len(pending)} pods")
    by_key = {f"default/{p.metadata.name}": p for p in pending}
    for d in ring:
        name = d["pod"].split("/")[-1]
        want = "bound" if bindings.get(name) else "unschedulable"
        if d["outcome"] != want or d.get("node") != bindings.get(name):
            fail(phase, f"{d['pod']}: decision {d['outcome']} at {d.get('node')}, bound at "
                        f"{bindings.get(name)}")
    unbound = [d for d in ring if not d.get("node")][:EXPLAIN_LIMIT]
    bound = [d for d in ring if d.get("node")][:EXPLAIN_LIMIT - len(unbound)]
    chosen = {d["pod"] for d in unbound + bound}
    tabled = {d["pod"] for d in ring if "nodes" in d}
    if tabled != chosen:
        fail(phase, f"verdict tables on {len(tabled)} pods, expected the tick's first "
                    f"{len(chosen)}: {sorted(tabled ^ chosen)[:3]}")
    after = []
    for p in pending:
        if bindings.get(p.metadata.name):
            q = copy.deepcopy(p)
            q.spec.node_name = bindings[p.metadata.name]
            after.append(q)
    t0 = time.perf_counter()
    refs = {}
    for decided, occupancy in ((bound, []), (unbound, after)):
        pods = [by_key[d["pod"]] for d in decided]
        for entry in explain_backlog(pods, nodes, occupancy, services, device="cpu",
                                     top_k=3, max_failed=16):
            refs[entry["pod"]] = entry
    cpu_s = time.perf_counter() - t0
    keys = ("feasibleNodes", "totalNodes", "nodes", "reasonCounts")
    for d in unbound + bound:
        ref = refs[d["pod"]]
        for k in keys:
            if d[k] == ref[k]:
                continue
            if k == "nodes":  # name the node: the entries carry it
                i = next((i for i, (x, y) in enumerate(zip(d[k], ref[k])) if x != y),
                         min(len(d[k]), len(ref[k])))
                fail(phase, f"{d['pod']}'s verdict table differs from the CPU's at entry {i}: "
                            f"card {d[k][i:i + 1]} != cpu {ref[k][i:i + 1]}")
            fail(phase, f"{d['pod']}'s {k} differs from the CPU's: card {d[k]} != cpu {ref[k]}")
    return {"decisions": len(ring), "tables": len(chosen), "unbound_tables": len(unbound),
            "equal_to_cpu": True, "cpu_explain_s": cpu_s, "tolerance": "exact"}


def run_daemon_parity(torch, device, wide=False, n_nodes=DAEMON_NODES):
    """1,024 pending pods over HTTP, then one schedule_batch() of a
    non-started daemon on the card: its bindings, read back by LIST,
    equal schedule_backlog's on the same objects and the plain K1
    version's, pod for pod. `wide` (leg daemon_parity_wide): hostname
    labels on every node and a disk on every tenth pod, past the 128
    tokens a vocabulary of a default session. On HOSTNAME_NODES nodes
    (leg daemon_parity_hostnames) K1's pod rows pass the 224 words two
    128-pod tiles hold."""
    import copy

    from kubernetes_tpu_torch.client.rest import Client, HTTPTransport
    from kubernetes_tpu_torch.ops import ledger, scan_kernel
    from kubernetes_tpu_torch.scheduler.batch import schedule_backlog
    from kubernetes_tpu_torch.scheduler.daemon import IncrementalBatchScheduler, SchedulerConfig
    from kubernetes_tpu_torch.utils import capacity

    phase = ("daemon_parity_hostnames" if n_nodes != DAEMON_NODES
             else "daemon_parity_wide" if wide else "daemon_parity")
    capacity.DEFAULT.reset()
    with ControlPlane(phase) as cp:
        client = Client(HTTPTransport(cp.url))
        _cluster(phase, client, hostname=wide, n_nodes=n_nodes)
        pods = [_parity_pod(i, wide, n_nodes) for i in range(DAEMON_PARITY_PODS)]
        _bulk(phase, lambda xs: client.create_bulk("pods", xs, namespace="default"), pods)
        cfg = SchedulerConfig(Client(HTTPTransport(cp.url))).start()
        try:
            if not cfg.wait_for_sync(60):
                fail(phase, "the daemon's caches did not sync")
            _wait(phase, "the pending pods in the queue",
                  lambda: len(cfg.pod_queue) == DAEMON_PARITY_PODS)
            q = cfg.pod_queue
            order = [q._items[k] for k in q._queue if k in q._items]  # the drain order
            pending = copy.deepcopy(order)
            nodes = cfg.nodes.store.list()
            services = cfg.service_lister.list()
            daemon = IncrementalBatchScheduler(cfg, max_batch=DAEMON_PARITY_PODS, device=device)
            _fresh_recorder()
            recording = _RecordTimer(daemon)
            explain0 = _phase_total("explain")
            scan_kernel.scan_with_state.launches = 0
            calls0 = ledger.DEFAULT.calls("scan_kernel")
            t0 = time.perf_counter()
            with _K1Events(torch) as k1:
                took = daemon.schedule_batch(timeout=1.0)
            tick_s = time.perf_counter() - t0
            recording.close()
            explain_n, explain_s = (b - a for a, b in zip(explain0, _phase_total("explain")))
            recorded = _RecordTimer.between({k: 0 for k in recording.totals},
                                            recording.snapshot(), 1)
            if device.type == "cuda":
                torch.cuda.synchronize()
            k1_ms = [a.elapsed_time(b) for a, b in k1.events]
            k1_plans = k1.plans
            launches = scan_kernel.scan_with_state.launches
            ledger_launches = ledger.DEFAULT.calls("scan_kernel") - calls0
            widths = (daemon._session.LW, daemon._session.PW, daemon._session.VW)
            capacity_check = _capacity_vs_plain(phase, daemon, pending)
            daemon.stop()
        finally:
            cfg.stop()
        bound, _, _ = _listed(client)
        command = cp.cmd
    got = [bound[p.metadata.name] for p in pending]
    explain_check = _explain_vs_cpu(phase, pending, bound, nodes, services)
    backlog = schedule_backlog(pending, nodes, device=device)
    plain = _plain_session(torch, device, nodes, pending=pending)
    for pod in pending:
        plain.add_pending(pod)
    plain_names = [n for _, n in plain.solve()]
    for ref, tag in ((backlog, "schedule_backlog"), (plain_names, "the plain K1 version")):
        diff = [i for i, (a, b) in enumerate(zip(got, ref)) if a != b]
        if diff or len(ref) != len(got):
            i = diff[0] if diff else 0
            fail(phase, f"the daemon's bindings differ from {tag} on {len(diff)} of {len(got)} "
                        f"pods; first {pending[i].metadata.name}: {got[i]} != {ref[i]}")
    if took != DAEMON_PARITY_PODS or launches != 1 or daemon.device_errors:
        fail(phase, f"the tick took {took} pods with {launches} K1 launches and "
                    f"{daemon.device_errors} errors")
    plan = k1_plans[0] if k1_plans else None
    return {
        "apiserver": " ".join(command), "nodes": n_nodes, "pods": len(got),
        "placed": sum(n is not None for n in got), "with_selector": sum(
            bool(p.spec.node_selector) for p in pending),
        "with_volume": sum(bool(p.spec.volumes) for p in pending),
        "session_words": dict(zip(("labels", "ports", "volumes"), widths)),
        "k1_plan": plan and {"row_words": plan.row_words, "tile": plan.tile,
                             "resident": plan.resident, "cluster": plan.cluster,
                             "nodes_per_cta": plan.nodes_per_cta, "threads": plan.threads,
                             "smem_bytes": plan.smem_bytes},
        "equal_to_schedule_backlog": True, "equal_to_plain": True, "tick_s": tick_s,
        "capacity": capacity_check,
        "flight_recorder": {**explain_check, "explain_phase_s": explain_s,
                            "explain_phases": explain_n, **recorded},
        "k1_ms": k1_ms, "launches": launches, "ledger_launches": ledger_launches,
        "tolerance": "exact (node name per pod; verdict tables entry for entry)",
    }


def _batch_parity(phase, cp, daemon_kw, policy=None):
    """The pending pods in the queue of a fresh full re-lower
    BatchScheduler (`daemon_kw`, typed scheduled-pods cache), one
    schedule_batch() of it, not started. Returns (pending pods in the
    drain order, nodes, assigned, services from the caches, the names
    bound as read back by LIST, the daemon, the tick's pods and
    seconds)."""
    import copy

    from kubernetes_tpu_torch.client.rest import Client, HTTPTransport
    from kubernetes_tpu_torch.scheduler.daemon import BatchScheduler, SchedulerConfig

    n_pending = DAEMON_PARITY_PODS
    client = Client(HTTPTransport(cp.url))
    cfg = SchedulerConfig(Client(HTTPTransport(cp.url)), policy=policy,
                          raw_scheduled_cache=False).start()
    try:
        if not cfg.wait_for_sync(60):
            fail(phase, "the daemon's caches did not sync")
        _wait(phase, "the pending pods in the queue", lambda: len(cfg.pod_queue) == n_pending)
        q = cfg.pod_queue
        pending = copy.deepcopy([q._items[k] for k in q._queue if k in q._items])
        nodes = cfg.nodes.store.list()
        assigned = cfg.pod_lister.list()
        services = cfg.service_lister.list()
        daemon = BatchScheduler(cfg, max_batch=n_pending, **daemon_kw)
        if daemon.sidecar is not None:
            daemon.sidecar.timeout = SIDECAR_WAIT_S
        t0 = time.perf_counter()
        took = daemon.schedule_batch(timeout=1.0)
        tick_s = time.perf_counter() - t0
        daemon.stop()
    finally:
        cfg.stop()
    bound, _, _ = _listed(client)
    return pending, nodes, assigned, services, [bound[p.metadata.name] for p in pending], \
        daemon, took, tick_s


def _same(phase, pending, got, ref, tag):
    diff = [i for i, (a, b) in enumerate(zip(got, ref)) if a != b]
    if diff or len(ref) != len(got):
        i = diff[0] if diff else 0
        fail(phase, f"the daemon's bindings differ from {tag} on {len(diff)} of {len(got)} "
                    f"pods; first {pending[i].metadata.name}: {got[i]} != {ref[i]}")


def run_daemon_policy_parity(torch, device):
    """Leg daemon_policy_parity: the full re-lower BatchScheduler under
    FULL_VOCABULARY_POLICY, one tick of 1,024 pods on 5,000 labelled
    nodes; its bindings equal schedule_backlog(spec=...)'s and the plain
    K1P version's on the same objects, and the tick launched K1P once."""
    from kubernetes_tpu_torch import workload
    from kubernetes_tpu_torch.client.rest import Client, HTTPTransport
    from kubernetes_tpu_torch.models.algspec import spec_from_policy
    from kubernetes_tpu_torch.models.columnar import build_snapshot
    from kubernetes_tpu_torch.ops import ledger, policy_scan
    from kubernetes_tpu_torch.ops.matrices import device_snapshot
    from kubernetes_tpu_torch.scheduler.batch import schedule_backlog

    phase = "daemon_policy_parity"
    policy = workload.FULL_VOCABULARY_POLICY
    with ControlPlane(phase) as cp:
        client = Client(HTTPTransport(cp.url))
        wires = _policy_cluster(phase, client, DAEMON_PARITY_PODS)
        _bulk(phase, lambda xs: client.create_bulk("pods", xs, namespace="default"), wires)
        policy_scan.policy_scan_with_state.launches = 0
        calls0 = ledger.DEFAULT.calls("policy_scan_kernel")
        with _K1Events(torch, policy=True) as k1p:
            pending, nodes, assigned, services, got, daemon, took, tick_s = _batch_parity(
                phase, cp, {"device": device}, policy=policy)
        torch.cuda.synchronize()
        launches = policy_scan.policy_scan_with_state.launches
        ledger_launches = ledger.DEFAULT.calls("policy_scan_kernel") - calls0
        k1p_ms = [a.elapsed_time(b) for a, b in k1p.events]
        command = cp.cmd
    spec = spec_from_policy(policy)
    _same(phase, pending, got, schedule_backlog(pending, nodes, assigned, services,
                                                device=device, spec=spec), "schedule_backlog")
    snap = build_snapshot(pending, nodes, assigned, services, spec=spec)
    d = device_snapshot(snap, device)
    choice, _ = policy_scan.plain_policy_scan_with_state(d.pods, _copy(d.nodes), d.weights,
                                                         d.lowered)
    names = snap.nodes.names
    _same(phase, pending, got, [names[i] if i >= 0 else None
                                for i in choice[:len(pending)].tolist()], "the plain K1P version")
    if took != DAEMON_PARITY_PODS or launches != 1 or daemon.device_errors:
        fail(phase, f"the tick took {took} pods with {launches} K1P launches and "
                    f"{daemon.device_errors} errors")
    return {
        "apiserver": " ".join(command), "nodes": len(nodes), "pods": len(got),
        "bound_peers": len(assigned), "services": len(services),
        "placed": sum(n is not None for n in got), "route": "policy scan (K1P)",
        "equal_to_schedule_backlog": True, "equal_to_plain": True, "tick_s": tick_s,
        "k1p_ms": k1p_ms, "launches": launches, "ledger_launches": ledger_launches,
        "tolerance": "exact (node name per pod)",
    }


def run_daemon_sidecar_parity(torch, device):
    """Leg daemon_sidecar_parity: the port's sidecar as a child process
    on the card and a non-started BatchScheduler solving through it,
    default spec, one tick of 1,024 pods on 5,000 nodes; the bindings
    equal schedule_backlog's, and the sidecar reports one K1 launch."""
    from kubernetes_tpu_torch.client.rest import Client, HTTPTransport
    from kubernetes_tpu_torch.ops import sidecar
    from kubernetes_tpu_torch.scheduler.batch import schedule_backlog

    phase = "daemon_sidecar_parity"
    proc, sock_path = None, None
    try:
        t0 = time.perf_counter()
        proc, sock_path = sidecar.spawn_sidecar(wait=SIDECAR_WAIT_S)
        start_s = time.perf_counter() - t0
        with ControlPlane(phase) as cp:
            client = Client(HTTPTransport(cp.url))
            _cluster(phase, client)
            pods = [_parity_pod(i, False) for i in range(DAEMON_PARITY_PODS)]
            _bulk(phase, lambda xs: client.create_bulk("pods", xs, namespace="default"), pods)
            pending, nodes, assigned, services, got, daemon, took, tick_s = _batch_parity(
                phase, cp, {"sidecar_path": sock_path})
            command = cp.cmd
        reported = daemon.sidecar.last_kernel_launches
    except sidecar.SidecarError as e:
        fail(phase, f"sidecar failure: {e}")
    finally:
        if proc is not None:
            _stop_process(proc)
            shutil.rmtree(os.path.dirname(sock_path), ignore_errors=True)
    _same(phase, pending, got, schedule_backlog(pending, nodes, assigned, services, device=device),
          "schedule_backlog")
    if took != DAEMON_PARITY_PODS or daemon.device_errors or daemon.device is not None:
        fail(phase, f"the tick took {took} pods with {daemon.device_errors} errors")
    if reported != {"scan_kernel": 1, "policy_scan_kernel": 0}:
        fail(phase, f"the sidecar reported {reported} launches, expected one K1 launch")
    return {
        "apiserver": " ".join(command), "nodes": len(nodes), "pods": len(got),
        "placed": sum(n is not None for n in got), "route": "sidecar (K1 in the child)",
        "sidecar_start_s": start_s, "equal_to_schedule_backlog": True, "tick_s": tick_s,
        "sidecar_kernel_launches": reported, "launches": reported["scan_kernel"],
        "tolerance": "exact (node name per pod)",
    }


def _drill_load(url, rate, creators, warmup_s, window_s, drain_s, lost_s, cushion, preload, conn):
    """The load generator's process: paced creators and a deleter over a
    lean keep-alive socket writer, and a watch (the port's client) on
    bound pods timestamping when each binding becomes visible. Sends
    "start" and "end" around the window, then the result: the window's
    latencies (create call start to binding visible), the pods created
    in it, those still unbound after `drain_s`, the pods (of the whole
    run) still unbound `lost_s` after the window, pods seen bound to two
    nodes, and the node each pod created in the window was bound to. Creates and deletes stop with the window. `preload`
    names bound pods the deleter takes first, oldest first."""
    import json as _json
    import socket
    import threading

    from kubernetes_tpu_torch.client.rest import Client, HTTPTransport

    host, port = url.split("//")[1].split(":")
    path = "/api/v1/namespaces/default/pods"
    lock, stop = threading.Lock(), threading.Event()
    t_create, t_call, t_bound, node_of, double = {}, {}, {}, {}, []
    bound_q = list(preload)
    errors = []

    class Lean:
        """Keep-alive HTTP/1.1 requests written straight to a socket
        (the stdlib client's parsing would make the load generator the
        bottleneck); reads status and Content-Length bodies only."""

        def __init__(self):
            self.sock, self.buf = None, b""

        def request(self, verb, target, body=b""):
            head = (f"{verb} {target} HTTP/1.1\r\nHost: a\r\nContent-Length: {len(body)}\r\n"
                    + ("Content-Type: application/json\r\n" if body else "") + "\r\n").encode()
            for attempt in (0, 1):
                if self.sock is None:
                    self.sock = socket.create_connection((host, int(port)))
                    self.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                    self.buf = b""
                try:
                    self.sock.sendall(head + body)
                    return self._status()
                except OSError:
                    self.sock = None  # a stale keep-alive: one retry
                    if attempt:
                        raise
            return 0

        def _status(self):
            while b"\r\n\r\n" not in self.buf:
                chunk = self.sock.recv(65536)
                if not chunk:
                    raise OSError("connection closed")
                self.buf += chunk
            head, self.buf = self.buf.split(b"\r\n\r\n", 1)
            lines = head.split(b"\r\n")
            clen = next((int(ln[15:]) for ln in lines[1:]
                         if ln[:15].lower() == b"content-length:"), 0)
            while len(self.buf) < clen:
                chunk = self.sock.recv(65536)
                if not chunk:
                    raise OSError("connection closed")
                self.buf += chunk
            self.buf = self.buf[clen:]
            return int(lines[0].split(b" ", 2)[1])

    def watcher(version):
        stream = Client(HTTPTransport(url)).watch("pods", namespace="default", since=version,
                                                  field_selector="spec.nodeName!=")
        try:
            while not done.is_set():
                ev = stream.next(timeout=0.2)
                if ev is None:
                    if stream.closed:
                        errors.append("the watch closed")
                        return
                    continue
                name = ev.object.get("metadata", {}).get("name")
                node = ev.object.get("spec", {}).get("nodeName")
                if not name or not node:
                    continue
                now = time.perf_counter()
                with lock:
                    if node_of.setdefault(name, node) != node:
                        double.append(name)
                    if name not in t_bound:
                        t_bound[name] = now
                        bound_q.append(name)
        finally:
            stream.close()

    seq = [0]

    def creator():
        c, interval, next_t = Lean(), creators / rate, time.perf_counter()
        while not stop.is_set():
            with lock:
                seq[0] += 1
                name = f"c{seq[0]}"
            body = _json.dumps(_daemon_pod_wire(name)).encode()
            t0 = time.perf_counter()
            with lock:
                t_create[name] = t0
            try:
                status = c.request("POST", path, body)
                if status >= 400 and status != 409:  # 409: our own resend raced the create
                    raise RuntimeError(f"create {name}: HTTP {status}")
                with lock:
                    t_call[name] = time.perf_counter() - t0
            except Exception as e:
                errors.append(repr(e))
                with lock:
                    t_create.pop(name, None)
                return
            next_t += interval
            delay = next_t - time.perf_counter()
            if delay > 0:
                time.sleep(delay)
            elif delay < -2.0:
                next_t = time.perf_counter()  # fell behind: re-anchor

    def deleter():
        c, interval, next_t = Lean(), 1.0 / rate, time.perf_counter()
        while not stop.is_set():
            name = None
            with lock:
                if len(bound_q) > cushion:
                    name = bound_q.pop(0)
            if name is not None:
                try:
                    c.request("DELETE", f"{path}/{name}")
                except Exception as e:
                    errors.append(repr(e))
                    return
            next_t += interval
            delay = next_t - time.perf_counter()
            if delay > 0:
                time.sleep(delay)
            elif delay < -2.0:
                next_t = time.perf_counter()

    done = threading.Event()
    try:
        _, version = Client(HTTPTransport(url)).list("pods", namespace="default")
        threads = [threading.Thread(target=watcher, args=(version,), daemon=True)]
        threads += [threading.Thread(target=creator, daemon=True) for _ in range(creators)]
        threads += [threading.Thread(target=deleter, daemon=True)]
        for t in threads:
            t.start()
        time.sleep(warmup_s)
        conn.send("start")
        t_start = time.perf_counter()
        time.sleep(window_s)
        t_end = time.perf_counter()
        stop.set()
        conn.send("end")

        def unbound(window_only):
            with lock:
                return [n for n, t0 in t_create.items()
                        if n not in t_bound and (not window_only or t_start <= t0 < t_end)]

        deadline = time.monotonic() + drain_s
        while unbound(True) and time.monotonic() < deadline:
            time.sleep(0.05)
        with lock:
            lats = sorted(t_bound[n] - t0 for n, t0 in t_create.items()
                          if t_start <= t0 < t_end and n in t_bound)
            created = sum(t_start <= t0 < t_end for t0 in t_create.values())
            calls = sorted(t_call[n] for n, t0 in t_create.items()
                           if t_start <= t0 < t_end and n in t_call)
            window_nodes = {n: node_of[n] for n, t0 in t_create.items()
                            if t_start <= t0 < t_end and n in node_of}
        after_drain = len(unbound(True))
        deadline = t_end + lost_s
        while unbound(False) and time.perf_counter() < deadline:
            time.sleep(0.1)
        lost = unbound(False)
        conn.send({"lats": lats, "created": created, "window_s": t_end - t_start, "calls": calls,
                   "unbound_after_drain": after_drain, "lost": lost[:20], "lost_count": len(lost),
                   "created_total": len(t_create), "double_bound": double[:20],
                   "errors": errors[:5], "window_nodes": window_nodes})
    except Exception as e:
        conn.send({"error": repr(e)})
    finally:
        stop.set()
        done.set()


class _K1Events:
    """CUDA events around every launch of K1 (`scan_kernel._launch`), or
    with `policy` of K1P (`policy_scan._launch`), while in the block;
    for K1 also the default plan of each launch."""

    def __init__(self, torch, policy=False):
        self.torch, self.events, self.plans, self._launch = torch, [], [], None
        self.policy = policy

    def _module(self):
        from kubernetes_tpu_torch.ops import policy_scan, scan_kernel

        return policy_scan if self.policy else scan_kernel

    def __enter__(self):
        module = self._module()
        self._launch = launch = module._launch
        cuda = self.torch.cuda

        def timed(*args, **kwargs):
            if not self.policy:
                self.plans.append(module.plan_for(args[0], args[1]))
            ev = (cuda.Event(enable_timing=True), cuda.Event(enable_timing=True))
            ev[0].record()
            out = launch(*args, **kwargs)
            ev[1].record()
            self.events.append(ev)
            return out

        module._launch = timed
        return self

    def __exit__(self, *exc):
        if self._launch is not None:
            self._module()._launch, self._launch = self._launch, None


def _pct(xs, p):
    """The p-quantile of sorted `xs`, as bench.py's drill reads it."""
    return xs[min(len(xs) - 1, int(p * len(xs)))] if xs else None


def _phase_total(name):
    """(count, seconds) of scheduler_phase_seconds{phase=name} so far."""
    from kubernetes_tpu_torch.utils import tracing

    snap = tracing.PHASE_SECONDS.snapshot().get((name,))
    return (snap[0], snap[1]) if snap else (0, 0.0)


def _hist(h, **labels):
    snap = h.snapshot().get(h._key(labels))
    return {"count": h.count(**labels), "sum": snap[1] if snap else 0.0,
            "p50": h.quantile(0.5, **labels), "p99": h.quantile(0.99, **labels)}


def _mirror_equal_to_rebuild(torch, device, phase, session, pods, nodes):
    """The daemon's session against a fresh session from the LIST, by
    node name: every host-mirror column of every node, and which node
    holds each pod; and its device rows against its mirror."""
    import numpy as np

    from kubernetes_tpu_torch.ops import SolverSession

    bound = [p for p in pods if p.spec.node_name]
    fresh = SolverSession(nodes, assigned=bound, node_capacity=max(64, int(len(nodes) * 1.25)),
                          device=device)
    if session.node_index.keys() != fresh.node_index.keys():
        fail(phase, "the session's nodes differ from the apiserver's")
    pods_at = {k: session.node_names[j] for k, j in session._pod_node.items()}
    want_at = {k: fresh.node_names[j] for k, j in fresh._pod_node.items()}
    if pods_at != want_at:
        bad = sorted(set(pods_at.items()) ^ set(want_at.items()))
        fail(phase, f"the session holds {len(pods_at)} pods and the LIST {len(want_at)}; "
                    f"first difference {bad[:2]}")
    names = [n for n in fresh.node_names if n is not None]
    rows, fresh_rows = [session.node_index[n] for n in names], [fresh.node_index[n] for n in names]
    for key, col in fresh.h.items():
        got, want = session.h[key][rows], col[fresh_rows]
        if got.dtype != want.dtype or not np.array_equal(got, want):
            fail(phase, f"the session's host column {key} differs from a rebuild's")
    return {"nodes": len(rows), "pods": len(pods_at),
            "device_rows_checked": _mirror_check(torch, session, "the daemon's session", phase)}


def run_daemon_drill(torch, device, smi, phase, preload=0, policy=False, stuck=0):
    """The pod-to-bind drill (the JAX package's bench.py:417-575 shape)
    against a fresh apiserver child: the port's daemon started on the
    card over its own HTTP transport, a spawned load generator, the
    window's latencies and throughput, the tick and device figures, and
    the checks (no double bind, a valid final placement, the session
    equal to a rebuild from the LIST, no device error, no lost pod).
    With `policy` (leg daemon_policy_drill) the daemon is the full
    re-lower BatchScheduler under FULL_VOCABULARY_POLICY over
    `workload.policy_objects`' nodes, services and peers: no session to
    check, K1P in place of K1, and `lower` a tick reported. `stuck` pods
    that fit no node are created before the daemon starts and retry
    through the load."""
    import multiprocessing as mp

    from kubernetes_tpu_torch import workload
    from kubernetes_tpu_torch.client.rest import Client, HTTPTransport
    from kubernetes_tpu_torch.models.columnar import build_snapshot
    from kubernetes_tpu_torch.ops import ledger, policy_scan, scan_kernel
    from kubernetes_tpu_torch.scheduler import daemon as daemon_mod
    from kubernetes_tpu_torch.utils import profiler, sli, tracing

    counter = policy_scan.policy_scan_with_state if policy else scan_kernel.scan_with_state
    kernel = "policy_scan_kernel" if policy else "scan_kernel"
    with ControlPlane(phase) as cp:
        client = Client(HTTPTransport(cp.url))
        t0 = time.perf_counter()
        if policy:
            _policy_cluster(phase, client, 0)
            preloaded = []
        else:
            preloaded = _cluster(phase, client, preload)
        if stuck:
            _bulk(phase, lambda xs: client.create_bulk("pods", xs, namespace="default"),
                  [_stuck_pod_wire(f"x{i}") for i in range(stuck)])
        setup_s = time.perf_counter() - t0
        cfg = daemon_mod.SchedulerConfig(
            Client(HTTPTransport(cp.url)),
            policy=workload.FULL_VOCABULARY_POLICY if policy else None,
            raw_scheduled_cache=not policy).start()
        daemon, k1, recording = None, _K1Events(torch, policy=policy), None
        try:
            if not cfg.wait_for_sync(120):
                fail(phase, "the daemon's caches did not sync")
            bound0 = len(cfg.scheduled_pods.store) if policy else preload
            _wait(phase, "the preloaded pods in the cache",
                  lambda: len(cfg.scheduled_pods.store) == bound0, timeout=120)
            t0 = time.perf_counter()
            if policy:
                daemon = daemon_mod.BatchScheduler(cfg, device=device)
                # Each tick is one solve: its pods, in order.
                handles, solve = [], daemon._solve

                def counted(pending, *rest):
                    handles.append(len(pending))
                    return solve(pending, *rest)

                daemon._solve = counted
            else:
                daemon = daemon_mod.IncrementalBatchScheduler(cfg, max_batch=1024,
                                                              prewarm_buckets=1024, device=device)
                daemon.prewarm()
                handles = _record_handles(daemon._session)
            torch.cuda.synchronize()
            build_s = time.perf_counter() - t0
            _fresh_recorder()
            recording = _RecordTimer(daemon)
            kernel_events = k1.__enter__().events
            window_series = (profiler.DUTY_CYCLE, profiler.OVERLAP, profiler.DEVICE_BUSY,
                             tracing.PHASE_SECONDS, daemon_mod._BIND_LATENCY,
                             sli.INFORMER_STALENESS)
            counter.launches = 0
            calls0 = ledger.DEFAULT.calls(kernel)
            daemon.start()
            ctx = mp.get_context("spawn")
            parent, child_conn = ctx.Pipe(duplex=False)
            load = ctx.Process(target=_drill_load, daemon=True, args=(
                cp.url, DRILL_RATE, DRILL_CREATORS, DRILL_WARMUP_S, DRILL_WINDOW_S, DRILL_DRAIN_S,
                DRILL_LOST_S, DRILL_CUSHION, preloaded, child_conn))
            gc.collect()
            gc.freeze()
            try:
                load.start()
                child_conn.close()
                msgs, pauses, recorded_at = {}, GcPauses(), {}
                for tag, wait_s in (("start", DRILL_WARMUP_S + 60),
                                    ("end", DRILL_WINDOW_S + 30)):
                    if not parent.poll(wait_s):
                        fail(phase, f"the load generator sent no {tag!r}")
                    msg = parent.recv()
                    if msg != tag:
                        fail(phase, f"the load generator failed: {msg}")
                    msgs[tag] = (cp.cpu_seconds(), time.process_time(), len(handles),
                                 len(kernel_events))
                    recorded_at[tag] = recording.snapshot()
                    if tag == "start":
                        for series in window_series:
                            series.reset()
                        pauses.__enter__()
                    else:
                        pauses.__exit__()
                        in_window = {
                            "duty_cycle": _hist(profiler.DUTY_CYCLE),
                            "overlap": _hist(profiler.OVERLAP),
                            "device_busy_s": profiler.DEVICE_BUSY.value(),
                            "phase_seconds": {p[0]: _hist(tracing.PHASE_SECONDS, phase=p[0])
                                              for p in tracing.PHASE_SECONDS.label_values()},
                            "bind_bulk_latency": _hist(daemon_mod._BIND_LATENCY),
                            "informer_staleness_s": {
                                k[0]: v for k, v in sli.INFORMER_STALENESS.snapshot().items()},
                        }
                if not parent.poll(DRILL_LOST_S + 30):
                    fail(phase, "the load generator sent no result")
                result = parent.recv()
            finally:
                gc.unfreeze()
                if load.pid is not None:
                    load.join(timeout=10)
                    if load.is_alive():
                        load.terminate()
                        load.join(timeout=10)
            if "error" in result:
                fail(phase, f"the load generator failed: {result['error']}")
            bound, pods, nodes = _listed(client)
            _wait(phase, "the daemon's caches to reach the LIST", lambda: {
                k.split("/")[-1] for k in cfg.scheduled_pods.store.keys()} == {
                n for n, v in bound.items() if v})
            time.sleep(1.0)
            daemon.stop()
            daemon.schedule_batch(timeout=0)  # one idle tick applies the last deltas
            launches = counter.launches
            ledger_launches = ledger.DEFAULT.calls(kernel) - calls0
            recorded_total = recording.snapshot()
            newest = _newest_decisions()
        finally:
            if daemon is not None and daemon._thread is not None and daemon._thread.is_alive():
                daemon.stop()
            if recording is not None:
                recording.close()
            cfg.stop()
            k1.__exit__()
        mirror = None if policy else _mirror_equal_to_rebuild(torch, device, phase,
                                                              daemon._session, pods, nodes)
        command = cp.cmd

    # The final placement under the capacity rule, counting every bound pod.
    placed = [p for p in pods if p.spec.node_name]
    snap = build_snapshot(placed, nodes)
    _valid(phase, snap, _assignment_of(snap, [p.spec.node_name for p in placed]), "final placement")
    (cpu_s, own_s, h_s, e_s), (cpu_e, own_e, h_e, e_e) = msgs["start"], msgs["end"]
    window = handles[h_s:h_e]
    per_tick = window if policy else [len(h.pending) for h in window]
    torch.cuda.synchronize()
    k1_ms = [a.elapsed_time(b) for a, b in kernel_events[e_s:e_e]]
    lats = result["lats"]
    problems = []
    if result["double_bound"]:
        problems.append(f"pods bound twice: {result['double_bound']}")
    if result["lost_count"]:
        problems.append(f"{result['lost_count']} pods lost (unbound {DRILL_LOST_S} s after the "
                        f"window): {result['lost']}")
    if daemon.device_errors:
        problems.append(f"{daemon.device_errors} device errors")
    if result["errors"]:
        problems.append(f"load generator errors: {result['errors']}")
    if not lats or not window:
        problems.append("no pod bound in the window")
    if policy and not launches:
        problems.append("no K1P launch")
    # Every pod bound in the window whose record is still in the ring:
    # its newest decision is `bound` at the node its binding names.
    in_ring = {n: node for n, node in result["window_nodes"].items() if f"default/{n}" in newest}
    wrong = [(n, newest[f"default/{n}"]["outcome"], newest[f"default/{n}"].get("node"), node)
             for n, node in in_ring.items()
             if (newest[f"default/{n}"]["outcome"], newest[f"default/{n}"].get("node"))
             != ("bound", node)]
    if not in_ring or wrong:
        problems.append(f"{len(wrong)} of {len(in_ring)} window pods in the ring without a "
                        f"bound decision at their node; first (pod, outcome, node, bound at) "
                        f"{wrong[:3]}")
    if problems:
        fail(phase, "; ".join(problems))
    lower = in_window["phase_seconds"].get("lower", {})
    sampled = in_window["phase_seconds"].get("capacity", {})
    checks = {"no_double_bind": True, "valid_final_placement": len(placed), "lost_pods": 0,
              "all_bound_by": f"{DRILL_LOST_S} s after the window"}
    if mirror is not None:
        checks["mirror_equal_to_rebuild"] = mirror
    extra = {"route": "policy scan (K1P), full re-lower", "rebuilds": None,
             "lower_s_per_tick": lower["sum"] / lower["count"] if lower.get("count") else None,
             } if policy else {"rebuilds": daemon.rebuilds}
    extra["capacity_samples"] = sampled.get("count", 0)
    extra["capacity_s_per_tick"] = sampled["sum"] / len(window) if sampled and window else None
    extra["capacity_share_of_window"] = sampled.get("sum", 0.0) / result["window_s"]
    explained = in_window["phase_seconds"].get("explain", {})
    extra["explain_phases"] = explained.get("count", 0)
    extra["explain_s_per_tick"] = explained["sum"] / len(window) if explained and window else 0.0
    extra["explain_share_of_window"] = explained.get("sum", 0.0) / result["window_s"]
    extra["flight_recorder"] = {
        "window": _RecordTimer.between(recorded_at["start"], recorded_at["end"], len(window)),
        "after_window": _RecordTimer.between(recorded_at["end"], recorded_total, 0),
        "record_share_of_window": (recorded_at["end"]["record_s"]
                                   - recorded_at["start"]["record_s"]
                                   - recorded_at["end"]["inline_explain_s"]
                                   + recorded_at["start"]["inline_explain_s"])
        / result["window_s"],
        "window_pods_in_ring": len(in_ring), "ring_decisions": len(newest)}
    checks["window_pods_with_bound_decision"] = len(in_ring)

    return {
        "card": smi, "apiserver": " ".join(command), "nodes": DAEMON_NODES,
        "preloaded_bound_pods": preload, "stuck_pods": stuck, "setup_s": setup_s, "session_build_s": build_s,
        "rate": DRILL_RATE, "creators": DRILL_CREATORS, "warmup_s": DRILL_WARMUP_S,
        "window_s": result["window_s"], "drain_s": DRILL_DRAIN_S,
        "bound_pods_per_s": len(lats) / result["window_s"],
        "bind_latency_p50_s": _pct(lats, 0.50), "bind_latency_p99_s": _pct(lats, 0.99),
        "bind_latency_max_s": lats[-1], "bound_in_window": len(lats),
        "created_in_window": result["created"],
        "created_per_s": result["created"] / result["window_s"],
        "create_call_p50_s": _pct(result["calls"], 0.50),
        "create_call_p99_s": _pct(result["calls"], 0.99),
        "unbound_after_drain": result["unbound_after_drain"], "lost": result["lost_count"],
        "created_total": result["created_total"], "double_bound": 0,
        "ticks": len(window), "pods_per_tick_mean": statistics.mean(per_tick),
        "pods_per_tick_max": max(per_tick),
        "k1_launches" if not policy else "k1p_launches": ledger_launches,
        "wrapper_launches": launches,
        "k1_ms_per_tick" if not policy else "k1p_ms_per_tick": k1_ms and {
            "median": statistics.median(k1_ms), "mean": statistics.mean(k1_ms),
            "max": max(k1_ms), "ticks_timed": len(k1_ms)},
        **in_window,
        "apiserver_cpu_s_window": cpu_e - cpu_s, "smoke_cpu_s_window": own_e - own_s,
        "gc_in_window": pauses.summary(),
        **extra, "device_errors": daemon.device_errors,
        "switch_interval_s": sys.getswitchinterval(),
        "checks": checks,
        "timed": "latency: the load process's clock from the start of the create call to the "
                 "binding on its own watch (spec.nodeName!=); create_call: the POST's round "
                 "trip; window figures between its 'start' and 'end'; K1 ms by CUDA events "
                 "around every K1 launch in the window; "
                 "duty, overlap, phases, bind_bulk latency and staleness from the registry, "
                 "reset at the window's start and read at its end; CPU seconds "
                 "from /proc/<pid>/stat (apiserver) and time.process_time (this process)",
    }


# -- the descheduler and the autoscaler on the card ------------------------------

DEFRAG_SLICE = ("slice-1x3000m", 3000.0, 1024.0, 1)  # the pending pods' shape, configured
DEFRAG_PENDING = 16  # one cycle's shards
DEFRAG_CYCLES = 1
DEFRAG_CAP = 16
REBIND_S = 30.0  # a replacement's time to bind at its destination
AUTOSCALE_BURST = 64
AUTOSCALE_STEP = 64
AUTOSCALE_POLLS = 12  # polls allowed for each of grow and shrink


def _sized_pod_wire(name, cpu, mem="1Gi"):
    return {"kind": "Pod", "metadata": {"name": name, "namespace": "default"},
            "spec": {"containers": [{"name": "c", "image": "app", "resources": {
                "limits": {"cpu": cpu, "memory": mem}}}]}}


def _bind_sized(phase, client, pods):
    """Create (name, cpu, node) pods and bind each to its node."""
    _bulk(phase, lambda xs: client.create_bulk("pods", xs, namespace="default"),
          [_sized_pod_wire(n, c) for n, c, _ in pods])
    _bulk(phase, lambda xs: client.bind_bulk(xs, namespace="default"),
          [(n, node) for n, _, node in pods])


class _PodWatch:
    """The default namespace's pods over the port's HTTP watch: for each
    pod incarnation (name, uid) the nodes it was seen bound to, each with
    the monotonic second it was first seen there."""

    def __init__(self, url, since):
        import threading

        from kubernetes_tpu_torch.client.rest import Client, HTTPTransport

        self.stream = Client(HTTPTransport(url)).watch("pods", namespace="default", since=since)
        self.bound = {}  # (name, uid) -> {node: first seen}
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        while not self._stop.is_set():
            ev = self.stream.next(timeout=0.5)
            if ev is None:
                if self.stream.closed:
                    return
                continue
            node = (ev.object.get("spec") or {}).get("nodeName")
            if node:
                meta = ev.object.get("metadata", {})
                self.bound.setdefault((meta.get("name"), meta.get("uid")), {}).setdefault(
                    node, time.monotonic())

    def close(self):
        self._stop.set()
        self.stream.close()
        self._thread.join(timeout=5)

    def bound_twice(self):
        """Pod incarnations seen bound to two nodes."""
        return sorted(k for k, v in list(self.bound.items()) if len(v) > 1)

    def bound_at(self, name, node, not_uid=None):
        """When an incarnation of `name` other than `not_uid` was first
        seen bound at `node` (None if not yet)."""
        seen = [at[node] for (n, uid), at in list(self.bound.items())
                if n == name and uid != not_uid and node in at]
        return min(seen) if seen else None

    def bound_names(self):
        return {n for n, _ in list(self.bound)}


class _K2Events:
    """CUDA events around every K2 launch (`rebalance._launch`) while in
    the block."""

    def __init__(self, torch):
        self.torch, self.events, self._launch = torch, [], None

    def __enter__(self):
        from kubernetes_tpu_torch.ops import rebalance

        self._launch = launch = rebalance._launch
        cuda = self.torch.cuda

        def timed(*args, **kwargs):
            ev = (cuda.Event(enable_timing=True), cuda.Event(enable_timing=True))
            ev[0].record()
            out = launch(*args, **kwargs)
            ev[1].record()
            self.events.append(ev)
            return out

        rebalance._launch = timed
        return self

    def __exit__(self, *exc):
        from kubernetes_tpu_torch.ops import rebalance

        if self._launch is not None:
            rebalance._launch, self._launch = self._launch, None

    def ms(self):
        self.torch.cuda.synchronize()
        return [a.elapsed_time(b) for a, b in self.events]


def _k2_plan_vs_plain(phase, args, outs, cols, names, pods, forced, budget, plan):
    """K2's outputs and `plan` against the plain version's on the same
    staged inputs, exactly. Rows after the one that spends the budget
    cannot commit, so the plain version runs up to that row only (all
    rows when the budget is not spent) and the rest are its no-moves."""
    import numpy as np
    import torch

    from kubernetes_tpu_torch.ops.rebalance import plan_moves
    from kubernetes_tpu_torch.utils.rebalance import group_plan, stage_rows

    dest, moved, gain, n_moves, before, after = outs
    d = len(dest)
    rows_run = int(np.nonzero(moved)[0][budget - 1]) + 1 if int(n_moves) >= budget > 0 else d
    trunc = [a[:rows_run] if 8 <= i <= 12 else a for i, a in enumerate(args[:17])]
    # One intra-op thread: the plain loop's small ops run several times
    # slower spread over the host's cores.
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        t0 = time.perf_counter()
        ref = [t.numpy() for t in plan_moves(*trunc, budget, device="cpu")]
        plain_s = time.perf_counter() - t0
    finally:
        torch.set_num_threads(threads)
    rdest, rmoved, rgain = np.full(d, -1, np.int32), np.zeros(d, bool), np.zeros(d, np.int32)
    rdest[:rows_run], rmoved[:rows_run], rgain[:rows_run] = ref[0], ref[1], ref[2]
    for tag, got, want in (("dest", dest, rdest), ("moved", moved, rmoved), ("gain", gain, rgain),
                           ("n_moves", n_moves, ref[3]), ("score_before", before, ref[4]),
                           ("score_after", after, ref[5])):
        if got.dtype != want.dtype or not np.array_equal(got, want):
            fail(phase, f"K2's {tag} differs from the plain version's")
    rows, *_, pod_force = stage_rows(cols, names, pods, forced)
    if group_plan(rows, names, pod_force, rdest, rmoved, rgain, budget, ref[4], ref[5]) != plan:
        fail(phase, "the plan differs from the plain version's")
    return {"rows": d, "rows_run_plain": rows_run, "plain_s": plain_s, "moves": int(n_moves)}


class _PlanSpy:
    """Wraps `build_plan` as the descheduler calls it and `plan_moves` as
    the planner calls it: each plan is held to the plain version's on
    its own inputs (`_k2_plan_vs_plain`)."""

    def __init__(self, phase):
        self.phase, self.checks, self._k2 = phase, [], []

    def __enter__(self):
        from kubernetes_tpu_torch.controllers import descheduler as desched_mod
        from kubernetes_tpu_torch.utils import rebalance as rebal_utils

        self._saved = (desched_mod.build_plan, rebal_utils.plan_moves)
        build, launch = self._saved

        def plan_moves(*args, device=None):
            out = launch(*args, device=device)
            self._k2.append((args, [t.cpu().numpy() for t in out]))
            return out

        def build_plan(cols, names, pods, probes, move_budget=32, forced_nodes=(), device=None):
            del self._k2[:]
            plan = build(cols, names, pods, probes, move_budget=move_budget,
                         forced_nodes=forced_nodes, device=device)
            if plan is not None:
                args, outs = self._k2[-1]
                self.checks.append(_k2_plan_vs_plain(self.phase, args, outs, cols, names, pods,
                                                     forced_nodes, int(move_budget), plan))
            return plan

        desched_mod.build_plan, rebal_utils.plan_moves = build_plan, plan_moves
        return self

    def __exit__(self, *exc):
        from kubernetes_tpu_torch.controllers import descheduler as desched_mod
        from kubernetes_tpu_torch.utils import rebalance as rebal_utils

        desched_mod.build_plan, rebal_utils.plan_moves = self._saved


class _MoveSpy:
    """Every move the descheduler makes: (name, from, to, old uid, start,
    evicted)."""

    def __init__(self, desched):
        self.moves = []
        move = desched._move

        def spy(pod, m, defer_bind=False):
            t = time.monotonic()
            ok = move(pod, m, defer_bind=defer_bind)
            self.moves.append((m["name"], m["from"], m["to"], pod["metadata"].get("uid"), t, ok))
            return ok

        desched._move = spy


def _started_daemon(phase, torch, device, cfg, n_bound):
    """The incremental daemon as the drills start it (max_batch 1,024,
    prewarm to 1,024), once the caches hold `n_bound` bound pods."""
    from kubernetes_tpu_torch.scheduler.daemon import IncrementalBatchScheduler

    if not cfg.wait_for_sync(120):
        fail(phase, "the daemon's caches did not sync")
    _wait(phase, "the preloaded pods in the cache",
          lambda: len(cfg.scheduled_pods.store) == n_bound, timeout=120)
    daemon = IncrementalBatchScheduler(cfg, max_batch=1024, prewarm_buckets=1024, device=device)
    daemon.prewarm()
    torch.cuda.synchronize()
    return daemon


def _counts():
    from kubernetes_tpu_torch.controllers import descheduler as desched_mod
    from kubernetes_tpu_torch.utils import rebalance as rebal_utils

    return {"stranded": rebal_utils.MOVES.value(outcome="stranded"),
            "sync_errors": desched_mod._SYNCS.value(result="error")}


def _pending_placed(client, pending, request_milli):
    """Whether every pending pod that fits is bound: none is left, or no
    live node has `request_milli` cpu free (a LIST, the capacity
    columns)."""
    from kubernetes_tpu_torch.utils.capacity import cluster_columns

    bound, pods, nodes = _listed(client)
    if all(bound.get(n) for n in pending):
        return True
    cols, _ = cluster_columns(nodes, pods)
    live = cols["sched"] & ~cols["over"]
    return float((cols["cpu_cap"] - cols["cpu_fit"])[live].max(initial=0.0)) < request_milli


def run_desched_defrag(torch, device, smi):
    """The descheduler on the card against the port's apiserver: 5,000
    nodes each keeping a 2,000m shard, DEFRAG_PENDING pods of 3,000m that
    fit none, the incremental daemon started, then DEFRAG_CYCLES cycles
    of `Descheduler.sync_once()` (grace 0, disruption cap 16, the JAX
    defaults otherwise) under the configured slice shape."""
    from kubernetes_tpu_torch.client.rest import Client, HTTPTransport
    from kubernetes_tpu_torch.controllers.descheduler import Descheduler
    from kubernetes_tpu_torch.ops import rebalance, scan_kernel
    from kubernetes_tpu_torch.scheduler.daemon import SchedulerConfig
    from kubernetes_tpu_torch.utils import capacity, flightrecorder, tracing
    from kubernetes_tpu_torch.utils import rebalance as rebal_utils

    phase = "desched_defrag"
    with ControlPlane(phase) as cp:
        client = Client(HTTPTransport(cp.url))
        t0 = time.perf_counter()
        _bulk(phase, lambda xs: client.create_bulk("nodes", xs),
              [_daemon_node_wire(j) for j in range(DAEMON_NODES)])
        preload = []
        for j in range(DAEMON_NODES):
            # Every node keeps 2,000m free: three 2,000m pods on 8 cpus,
            # one large pod and two of 1,000m on 16 and 32.
            sizes = (("2000m",) * 3, ("12000m", "1000m", "1000m"),
                     ("28000m", "1000m", "1000m"))[j % 3]
            preload += [(f"b{j}-{k}", c, f"n{j}") for k, c in enumerate(sizes)]
        _bind_sized(phase, client, preload)
        setup_s = time.perf_counter() - t0
        capacity.DEFAULT.reset()
        capacity.DEFAULT.configure([DEFRAG_SLICE])
        rebal_utils.DEFAULT.reset()
        _fresh_recorder()
        cfg = SchedulerConfig(Client(HTTPTransport(cp.url))).start()
        daemon = watch = None
        try:
            daemon = _started_daemon(phase, torch, device, cfg, len(preload))
            _, version = client.list_wire("nodes")
            watch = _PodWatch(cp.url, version)
            counts0 = _counts()
            scan_kernel.scan_with_state.launches = 0
            rebalance.plan_moves.launches = 0
            daemon.start()
            pending = [f"w{i}" for i in range(DEFRAG_PENDING)]
            _bulk(phase, lambda xs: client.create_bulk("pods", xs, namespace="default"),
                  [_sized_pod_wire(n, "3000m") for n in pending])
            # The daemon's samples note the pending pods' shape.
            _wait(phase, "the backlog's shape in the probe set",
                  lambda: len(capacity.DEFAULT.probe_set()) > 1, timeout=60)
            names0 = set(_listed(client)[0])
            desched = Descheduler(Client(HTTPTransport(cp.url)), grace_period_seconds=0,
                                  disruption_cap=DEFRAG_CAP, device=device)
            moves = _MoveSpy(desched)
            cycles, k2_ms = [], []
            with _PlanSpy(phase) as spy:
                for c in range(DEFRAG_CYCLES):
                    timer, done = tracing.PhaseTimer(), len(moves.moves)
                    t1 = time.perf_counter()
                    with tracing.timing(timer), _K2Events(torch) as k2:
                        out = desched.sync_once()
                    wall = time.perf_counter() - t1
                    k2_ms.append(k2.ms())
                    mine = moves.moves[done:]
                    if out["moves_executed"] > DEFRAG_CAP or out["moves_executed"] != sum(
                            m[5] for m in mine):
                        fail(phase, f"cycle {c} executed {out['moves_executed']} moves "
                                    f"({len(mine)} tried) under a cap of {DEFRAG_CAP}")
                    # Every replacement binds at its destination.
                    _wait(phase, f"cycle {c}'s replacements bound at their destinations",
                          lambda: all(watch.bound_at(n, to, uid) for n, _, to, uid, _, ok in mine
                                      if ok), timeout=REBIND_S)
                    # The next plan sees the shards this one opened taken: a
                    # plan that counted on one a pending pod then takes
                    # would pin a replacement where it no longer fits.
                    t1 = time.perf_counter()
                    _wait(phase, "the pending pods placed where they fit",
                          lambda: _pending_placed(client, pending, 3000.0), timeout=REBIND_S)
                    settle_s = time.perf_counter() - t1
                    cycles.append({"summary": out, "wall_s": wall, "phases_s": dict(timer.seconds),
                                   "k2_ms": k2_ms[-1], "plain_check": spy.checks[-1],
                                   "moves_tried": len(mine), "settle_s": settle_s})
            _wait(phase, "the pending pods bound",
                  lambda: watch.bound_names() >= set(pending), timeout=REBIND_S)
            bound, _, _ = _listed(client)
            templates, _ = client.list_wire("podtemplates")
            time.sleep(0.5)
            k1_launches = scan_kernel.scan_with_state.launches
            k2_launches = rebalance.plan_moves.launches
            counts1 = _counts()
            rebound = [watch.bound_at(n, to, uid) - t for n, _, to, uid, t, ok in moves.moves if ok]
            twice = watch.bound_twice()
            records = flightrecorder.DEFAULT.decisions(limit=1 << 30)["decisions"]
            errors = daemon.device_errors
        finally:
            if watch is not None:
                watch.close()
            if daemon is not None:
                daemon.stop()
            cfg.stop()
        command = cp.cmd
    problems = []
    if set(bound) != names0:
        problems.append(f"pod names changed: {sorted(set(bound) ^ names0)[:4]}")
    if twice:
        problems.append(f"pods bound twice: {twice[:4]}")
    if templates:
        problems.append(f"{len(templates)} journal entries left")
    if counts1 != counts0:
        problems.append(f"stranded or sync errors: {counts0} -> {counts1}")
    if errors:
        problems.append(f"{errors} device errors")
    # A cycle with no pending pod left is not triggered and measures nothing.
    triggered = [c["summary"] for c in cycles if c["summary"]["triggered"]]
    before = triggered[0]["score_before"] if triggered else None
    after = triggered[-1]["score_after"] if triggered else None
    if not triggered or not after < before:
        problems.append(f"the measured score did not drop: {before} -> {after}")
    if not k2_launches or not k1_launches:
        problems.append(f"K2 launched {k2_launches} times, K1 {k1_launches}")
    # Each executed move: a rebalance_nominated record at its destination.
    nominated = {(d["pod"], d.get("nominatedNode")) for d in records
                 if d["outcome"] == "rebalance_nominated"}
    unrecorded = [(n, to) for n, _, to, _, _, ok in moves.moves
                  if ok and (f"default/{n}", to) not in nominated]
    if unrecorded:
        problems.append(f"{len(unrecorded)} moves without a rebalance_nominated record at their "
                        f"destination: {unrecorded[:3]}")
    if problems:
        fail(phase, "; ".join(problems))
    executed = sum(c["summary"]["moves_executed"] for c in cycles)
    execute_s = sum(c["phases_s"].get("execute", 0.0) for c in cycles)
    rebound.sort()
    return {
        "card": smi, "apiserver": " ".join(command), "nodes": DAEMON_NODES,
        "bound_pods": len(preload), "pending_pods": DEFRAG_PENDING, "slice": DEFRAG_SLICE,
        "setup_s": setup_s, "disruption_cap": DEFRAG_CAP, "cycles": cycles,
        "moves_executed": executed, "ms_per_move": 1000.0 * execute_s / max(executed, 1),
        "evict_to_rebind_p50_s": _pct(rebound, 0.50), "evict_to_rebind_p99_s": _pct(rebound, 0.99),
        "evict_to_rebind_max_s": rebound[-1] if rebound else None,
        "score_before": before, "score_after": after, "cycles_triggered": len(triggered),
        "k2_launches": k2_launches, "k1_launches": k1_launches,
        "checks": {"plans_equal_plain": len(cycles), "cap_held": True,
                   "replacements_bound_at_destination": executed, "names_unchanged": len(names0),
                   "bound_twice": 0, "journals_left": 0, "stranded": 0, "sync_errors": 0,
                   "pending_bound": DEFRAG_PENDING,
                   "moves_with_rebalance_nominated_record": executed},
        "timed": "cycle wall and phases by the host clock around sync_once (PhaseTimer); K2 ms "
                 "by CUDA events around each launch (the plan's, then the measured score's); "
                 "evict to rebind from the move's start to the replacement bound at its "
                 "destination on this process's watch",
    }


class _HollowPool:
    """A node pool of Node objects over HTTP (as tools/soak.py's hollow
    pool): `grow` creates 8-cpu nodes g0000, g0001, ..., `shrink` deletes
    one. Its members are the nodes it started with and those it grew."""

    name = "hollow"

    def __init__(self, client, members):
        self.client, self.members, self.grown = client, list(members), 0

    def size(self):
        return len(self.members)

    def node_names(self):
        return list(self.members)

    def grow(self, k):
        wires = []
        for _ in range(k):
            wire = _daemon_node_wire(0)
            wire["metadata"]["name"] = f"g{self.grown:04d}"
            wires.append(wire)
            self.grown += 1
        _bulk("autoscale_cycle", lambda xs: self.client.create_bulk("nodes", xs), wires)
        added = [w["metadata"]["name"] for w in wires]
        self.members += added
        return added

    def shrink(self, name):
        self.client.delete("nodes", name)
        self.members.remove(name)


def _polls(phase, scaler, want, limit=AUTOSCALE_POLLS):
    """Poll until the action `want`; each poll's wall and summary."""
    out = []
    for _ in range(limit):
        t0 = time.perf_counter()
        summary = scaler.sync_once()
        out.append({"wall_s": time.perf_counter() - t0, "action": summary["action"],
                    "size": summary["size"], "pending": summary["pending"],
                    "mean_cpu_util": summary["mean_cpu_util"],
                    "start": time.monotonic() - (time.perf_counter() - t0),
                    "end": time.monotonic()})
        if summary["action"] == want:
            return out
        time.sleep(0.2)
    fail(phase, f"no {want!r} in {limit} polls: {[p['action'] for p in out]}")


def run_autoscale_cycle(torch, device, smi):
    """The autoscaler on the card against the port's apiserver: 5,000
    nodes filled to 500m free, a burst of AUTOSCALE_BURST pods of 2,000m,
    polls until the pool grows by AUTOSCALE_STEP and the burst binds on
    the new nodes; then the fillers and the burst deleted, one small pod
    left a node, polls through cordon, drain (K2 with the node forced)
    and shrink."""
    from kubernetes_tpu_torch.client.rest import Client, HTTPTransport
    from kubernetes_tpu_torch.controllers.autoscaler import Autoscaler
    from kubernetes_tpu_torch.ops import rebalance, scan_kernel
    from kubernetes_tpu_torch.scheduler.daemon import SchedulerConfig
    from kubernetes_tpu_torch.utils import capacity
    from kubernetes_tpu_torch.utils import rebalance as rebal_utils

    phase = "autoscale_cycle"
    with ControlPlane(phase) as cp:
        client = Client(HTTPTransport(cp.url))
        t0 = time.perf_counter()
        nodes = [f"n{j}" for j in range(DAEMON_NODES)]
        _bulk(phase, lambda xs: client.create_bulk("nodes", xs),
              [_daemon_node_wire(j) for j in range(DAEMON_NODES)])
        cpus = [(8, 16, 32)[j % 3] for j in range(DAEMON_NODES)]
        fillers = [(f"fill{j}", f"{cpus[j] * 1000 - 600}m", nodes[j]) for j in range(DAEMON_NODES)]
        smalls = [(f"small{j}", "100m", nodes[j]) for j in range(DAEMON_NODES)]
        _bind_sized(phase, client, fillers + smalls)
        setup_s = time.perf_counter() - t0
        capacity.DEFAULT.reset()
        rebal_utils.DEFAULT.reset()
        cfg = SchedulerConfig(Client(HTTPTransport(cp.url))).start()
        daemon = watch = None
        try:
            daemon = _started_daemon(phase, torch, device, cfg, len(fillers) + len(smalls))
            _, version = client.list_wire("nodes")
            watch = _PodWatch(cp.url, version)
            counts0 = _counts()
            scan_kernel.scan_with_state.launches = 0
            rebalance.plan_moves.launches = 0
            daemon.start()
            pool = _HollowPool(Client(HTTPTransport(cp.url)), nodes)
            scaler = Autoscaler(Client(HTTPTransport(cp.url)), pool, min_size=DAEMON_NODES,
                                max_size=DAEMON_NODES + AUTOSCALE_STEP, grow_after=2,
                                grow_step=AUTOSCALE_STEP, shrink_after=2, device=device)
            burst = [f"burst{i}" for i in range(AUTOSCALE_BURST)]
            _bulk(phase, lambda xs: client.create_bulk("pods", xs, namespace="default"),
                  [_sized_pod_wire(n, "2000m") for n in burst])
            grow = _polls(phase, scaler, "grow")
            _wait(phase, "the burst bound", lambda: watch.bound_names() >= set(burst),
                  timeout=REBIND_S)
            at = _listed(client)[0]
            grow_to_bound_s = max(watch.bound_at(n, at[n]) for n in burst) - grow[-1]["end"]
            off_pool = [n for n in burst if not at[n].startswith("g")]
            if off_pool or pool.size() != DAEMON_NODES + AUTOSCALE_STEP:
                fail(phase, f"the burst bound off the new nodes ({off_pool[:4]}) or the pool "
                            f"is {pool.size()}")
            # Shrink: the fillers and the burst go, one small pod a node stays.
            gone = [n for n, _, _ in fillers] + burst
            for s in range(0, len(gone), PRELOAD_BATCH):
                client.t._do("POST", "/api/v1/namespaces/default/pods:bulkdelete",
                             body={"names": gone[s:s + PRELOAD_BATCH]})
            grown = pool.members[DAEMON_NODES:]
            _bind_sized(phase, client, [(f"gsmall{i}", "100m", g) for i, g in enumerate(grown)])
            names0 = set(_listed(client)[0])
            _wait(phase, "the caches to settle", lambda: len(cfg.scheduled_pods.store) == len(
                names0) and not len(cfg.pod_queue), timeout=60)
            shrink = _polls(phase, scaler, "shrink")
            drain = [p for p in shrink if p["action"] == "drain"]
            retired = [n for n in grown if n not in pool.members]
            moved = [m for m in rebal_utils.DEFAULT.snapshot()["moves"] if m["forced"]]
            if len(retired) != 1 or len(moved) != 1 or not drain:
                fail(phase, f"retired {retired}, forced moves {moved}, actions "
                            f"{[p['action'] for p in shrink]}")
            victim, m = retired[0], moved[0]
            _wait(phase, "the drained pod bound elsewhere",
                  lambda: watch.bound_at(m["name"], m["to"]) is not None, timeout=REBIND_S)
            bound, _, listed_nodes = _listed(client)
            k1_launches = scan_kernel.scan_with_state.launches
            k2_launches = rebalance.plan_moves.launches
            counts1 = _counts()
            twice = watch.bound_twice()
            errors = daemon.device_errors
        finally:
            if watch is not None:
                watch.close()
            if daemon is not None:
                daemon.stop()
            cfg.stop()
        command = cp.cmd
    problems = []
    if set(bound) != names0:
        problems.append(f"pods lost or added: {sorted(set(bound) ^ names0)[:4]}")
    if victim in {n.metadata.name for n in listed_nodes} or m["from"] != victim:
        problems.append(f"node {victim} still listed, or the drain moved from {m['from']}")
    if pool.size() != DAEMON_NODES + AUTOSCALE_STEP - 1:
        problems.append(f"the pool is {pool.size()}")
    if twice:
        problems.append(f"pods bound twice: {twice[:4]}")
    if counts1 != counts0 or errors:
        problems.append(f"stranded, sync or device errors: {counts0} -> {counts1}, {errors}")
    if not k2_launches or not k1_launches:
        problems.append(f"K2 launched {k2_launches} times, K1 {k1_launches}")
    if problems:
        fail(phase, "; ".join(problems))
    drain_to_retire_s = shrink[-1]["end"] - drain[0]["start"]
    for p in grow + shrink:
        p.pop("start")
        p.pop("end")
    return {
        "card": smi, "apiserver": " ".join(command), "nodes": DAEMON_NODES, "setup_s": setup_s,
        "burst": AUTOSCALE_BURST, "grow_step": AUTOSCALE_STEP, "grow_polls": grow,
        "shrink_polls": shrink, "grow_to_bound_s": grow_to_bound_s,
        "drain_to_retire_s": drain_to_retire_s,
        "retired": victim, "drained_pod": {"name": m["name"], "to": m["to"]},
        "pool_size": pool.size(), "k2_launches": k2_launches, "k1_launches": k1_launches,
        "checks": {"burst_on_new_nodes": AUTOSCALE_BURST, "drained_pod_bound_elsewhere": True,
                   "node_gone": True, "pool_one_smaller": True, "pods_kept": len(names0),
                   "bound_twice": 0, "stranded": 0, "sync_errors": 0},
        "timed": "poll walls by the host clock around sync_once; grow to bound from the end of "
                 "the grow poll to the last burst pod bound on this process's watch; drain to "
                 "retire from the start of the drain poll to the end of the shrink poll",
    }


# -- the scheduler's command and its debug server ---------------------------------

DEBUG_FITTING = 1024  # pods that fit
DEBUG_STUCK = 8  # pods whose cpu request is above every node's
DEBUG_QUIET_S = 2.0  # quiet after the binds: the deferred verdict tables attach
DEBUG_UP_S = 180.0  # the command's start: imports, caches, session build and prewarm
DEBUG_TRACE_S = 5.0  # the command's device trace over the load (K1's time a launch)
DEBUG_TRACE_LEAD_S = 1.0  # the trace's start before the load


class _Scheduler:
    """The port's scheduler command as a child process on the card:
    `python -m kubernetes_tpu_torch.cmd.scheduler --batch --server URL
    --healthz-port PORT [extra]`, its output in a temporary file,
    stopped by SIGTERM (its exit code read) or killed with its process
    group."""

    def __init__(self, phase, url, device, extra=()):
        import tempfile

        self.phase, self.port = phase, _free_port()
        self.url = f"http://127.0.0.1:{self.port}"
        self.cmd = [sys.executable, "-m", "kubernetes_tpu_torch.cmd.scheduler", "--batch",
                    "--server", url, "--healthz-port", str(self.port), *extra]
        if device.type != "cuda":  # a dry run on the CPU
            self.cmd += ["--device", "cpu"]
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(p for p in (REPO, env.get("PYTHONPATH")) if p)
        self._log = tempfile.TemporaryFile()
        self.proc = subprocess.Popen(self.cmd, cwd=REPO, env=env, stdin=subprocess.DEVNULL,
                                     stdout=self._log, stderr=subprocess.STDOUT,
                                     start_new_session=True)

    def tail(self, n=3000):
        return _log_tail(self._log, n)

    def get(self, path, timeout=60):
        """(status, body) of a GET on the command's server."""
        import urllib.error
        import urllib.request

        try:
            with urllib.request.urlopen(self.url + path, timeout=timeout) as resp:
                return resp.status, resp.read().decode()
        except urllib.error.HTTPError as e:
            return e.code, e.read().decode()

    def get_json(self, path, timeout=60):
        code, body = self.get(path, timeout)
        if code != 200:
            fail(self.phase, f"GET {path}: HTTP {code}: {body[:300]}")
        return json.loads(body)

    def wait_up(self):
        deadline = time.monotonic() + DEBUG_UP_S
        while True:
            if self.proc.poll() is not None:
                fail(self.phase, f"the scheduler command exited with {self.proc.returncode}: "
                                 f"{self.tail()}")
            try:
                if self.get("/healthz", timeout=2) == (200, "ok"):
                    return
            except OSError:
                pass
            if time.monotonic() > deadline:
                self.kill()
                fail(self.phase, f"the command's /healthz did not answer in {DEBUG_UP_S} s: "
                                 f"{self.tail()}")
            time.sleep(0.2)

    def terminate(self, timeout=60):
        """SIGTERM; the exit code (None if it had to be killed)."""
        import signal

        if self.proc.poll() is None:
            os.killpg(self.proc.pid, signal.SIGTERM)
            try:
                return self.proc.wait(timeout=timeout)
            except subprocess.TimeoutExpired:
                self.kill()
                return None
        return self.proc.returncode

    def kill(self):
        import signal

        if self.proc.poll() is None:
            try:
                os.killpg(self.proc.pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
            self.proc.wait(timeout=10)


def _stuck_pod_wire(name):
    """A churn pod asking for 64 cpus: more than any node has."""
    wire = _daemon_pod_wire(name)
    wire["spec"]["containers"][0]["resources"]["limits"]["cpu"] = "64"
    return wire


def _trace_kernels(trace_dir):
    """The kernel events of a torch.profiler Chrome trace: (device ms of
    every K1 launch in order, {kernel name: [launches, device ms]})."""
    path = os.path.join(trace_dir, "trace.json")
    if not os.path.exists(path):
        return [], {}
    with open(path) as f:
        events = [e for e in json.load(f).get("traceEvents", [])
                  if e.get("cat") == "kernel" and "dur" in e]
    by_name = {}
    for e in events:
        row = by_name.setdefault(e.get("name", "")[:100], [0, 0.0])
        row[0] += 1
        row[1] += e["dur"] / 1000.0
    k1 = [e["dur"] / 1000.0 for e in sorted(events, key=lambda e: e.get("ts", 0))
          if "scan_kernel" in e.get("name", "") and "policy" not in e.get("name", "")]
    return k1, by_name


def _k1_calls(kernels_view):
    """K1's launches in a /debug/kernels body (0 before the first)."""
    return next((r["calls"] for r in kernels_view["kernels"]
                 if (r["kernel"], r["impl"]) == ("scan_kernel", "cuda")), 0)


def _settled_k1_calls(sched):
    """The command's K1 launches once its session prewarm has launched
    and stopped: nonzero and the same for a second."""
    deadline = time.monotonic() + DEBUG_UP_S
    last = None
    while time.monotonic() < deadline:
        calls = _k1_calls(sched.get_json("/debug/kernels"))
        if calls and calls == last:
            return calls
        last = calls
        time.sleep(1.0)
    fail(sched.phase, f"the command's prewarm launches did not settle in {DEBUG_UP_S} s "
                      f"(K1 calls {last}): {sched.tail()}")


def run_daemon_debug(torch, device, smi):
    """The port's scheduler command as a child on the card, read only
    over HTTP: DEBUG_FITTING pods that fit and DEBUG_STUCK that fit no
    node on 5,000 nodes; its health, metrics and every debug view held
    to what the flight recorder must show."""
    import re
    import threading

    from kubernetes_tpu_torch.client.rest import Client, HTTPTransport

    phase = "daemon_debug"
    t_leg = time.perf_counter()
    with ControlPlane(phase) as cp:
        client = Client(HTTPTransport(cp.url))
        _cluster(phase, client)
        sched = _Scheduler(phase, cp.url, device)
        profile_dir = None
        try:
            sched.wait_up()
            up_s = time.perf_counter() - t_leg
            # A first, idle capture: the profiler's one-time start-up in
            # the command (seconds), which would hide the load's first
            # ticks from the trace below.
            code, body = sched.get("/debug/device-profile?seconds=1")
            profile_dir = json.loads(body)["dir"] if code == 200 else None
            profile_exists = bool(profile_dir) and os.path.isdir(profile_dir)
            # K1's launches before the load: the session prewarm's, once
            # they have stopped (the session builds after /healthz is up).
            k1_before = _settled_k1_calls(sched)
            fitting = [f"g{i}" for i in range(DEBUG_FITTING)]
            stuck = [f"x{i}" for i in range(DEBUG_STUCK)]
            # A device trace over the load.
            profiled = {}
            prof = threading.Thread(target=lambda: profiled.update(zip(
                ("code", "body"), sched.get(f"/debug/device-profile?seconds={DEBUG_TRACE_S}"))))
            prof.start()
            time.sleep(DEBUG_TRACE_LEAD_S)
            t0 = time.perf_counter()
            _bulk(phase, lambda xs: client.create_bulk("pods", xs, namespace="default"),
                  [_daemon_pod_wire(n) for n in fitting] + [_stuck_pod_wire(n) for n in stuck])
            _wait(phase, "the fitting pods bound",
                  lambda: all(map(_listed(client)[0].get, fitting)), timeout=120)
            bound_s = time.perf_counter() - t0
            prof.join(timeout=60)
            time.sleep(DEBUG_QUIET_S)
            settle_s = time.perf_counter() - t0
            bindings = _listed(client)[0]
            health = sched.get("/healthz")
            metrics_body = sched.get("/metrics")[1]
            decisions = sched.get_json("/debug/decisions?limit=4096")["decisions"]
            solves = sched.get_json("/debug/solves?limit=512")["solves"]
            kernels = sched.get_json("/debug/kernels")
            capacity_view = sched.get_json("/debug/capacity")
            slo_view = sched.get_json("/debug/slo")
            rebalance_view = sched.get_json("/debug/rebalance")
            by_name = sched.get_json(f"/debug/decisions?pod={fitting[7]}")["decisions"]
            by_stuck = sched.get_json(f"/debug/decisions?pod={stuck[0]}")["decisions"]
            traces = sched.get_json(f"/debug/traces?pod={fitting[7]}")["traces"]
            stacks = sched.get("/debug/stacks")
            if profiled.get("code") != 200:
                fail(phase, f"/debug/device-profile?seconds={DEBUG_TRACE_S}: {profiled}")
            trace_dir = json.loads(profiled["body"])["dir"]
            k1_trace_ms, traced_kernels = _trace_kernels(trace_dir)
            shutil.rmtree(trace_dir, ignore_errors=True)
            rc = sched.terminate()
        finally:
            sched.kill()
            if profile_dir:
                shutil.rmtree(profile_dir, ignore_errors=True)
        log = sched.tail()
        command = cp.cmd

    problems = []
    if health != (200, "ok"):
        problems.append(f"/healthz answered {health}")
    m = re.search(r'^scheduler_decisions_total\{outcome="bound"\} ([0-9.e+]+)$', metrics_body,
                  re.M)
    bound_events = float(m.group(1)) if m else 0.0
    if bound_events < DEBUG_FITTING:
        problems.append(f"scheduler_decisions_total{{outcome=bound}} is {bound_events}")
    newest = {}
    for d in decisions:
        newest.setdefault(d["pod"], d)
    wrong = [(n, newest.get(f"default/{n}", {}).get("outcome"),
              newest.get(f"default/{n}", {}).get("node"), bindings.get(n)) for n in fitting
             if (newest.get(f"default/{n}", {}).get("outcome"),
                 newest.get(f"default/{n}", {}).get("node")) != ("bound", bindings.get(n))]
    if wrong:
        problems.append(f"{len(wrong)} fitting pods without a bound decision at their node; "
                        f"first (pod, outcome, node, bound at) {wrong[:3]}")
    for n in stuck:
        d = newest.get(f"default/{n}", {})
        if (d.get("outcome"), d.get("feasibleNodes"), d.get("totalNodes")) != (
                "unschedulable", 0, DAEMON_NODES) or "PodFitsResources" not in d.get(
                    "reasonCounts", {}):
            problems.append(f"{n}'s newest decision: {json.dumps(d)[:400]}")
            break
    per_tick = {}
    for d in decisions:
        per_tick.setdefault(d["tick"], []).append(d)
    over = {t: sum("nodes" in d for d in ds) for t, ds in per_tick.items()
            if sum("nodes" in d for d in ds) > EXPLAIN_LIMIT}
    bound_ticks = [t for t, ds in per_tick.items() if any(d["outcome"] == "bound" for d in ds)]
    newest_tick = max(bound_ticks) if bound_ticks else None
    tabled = [d for d in per_tick.get(newest_tick, ()) if d["outcome"] == "bound" and "nodes" in d]
    if over or not tabled:
        problems.append(f"verdict tables: ticks over {EXPLAIN_LIMIT}: {over}; the newest tick "
                        f"with bound pods ({newest_tick}) has {len(tabled)} bound pods with tables")
    if not by_name or by_name[0]["pod"] != f"default/{fitting[7]}":
        problems.append(f"?pod={fitting[7]} returned {[d['pod'] for d in by_name[:2]]}")
    incremental = [r for r in solves if r.get("incremental")]
    if sum(r["pods"] for r in incremental) < DEBUG_FITTING + DEBUG_STUCK:
        problems.append(f"incremental solve records hold {sum(r['pods'] for r in incremental)} "
                        f"pods")
    solve_ids = {r["traceId"] for r in solves}
    orphans = {d["traceId"] for d in decisions if d["traceId"] and d["traceId"] not in solve_ids}
    if orphans:
        problems.append(f"decision trace ids not in /debug/solves: {sorted(orphans)[:3]}")
    if not traces or fitting[7] not in traces[0].get("pods", []):
        problems.append(f"/debug/traces?pod={fitting[7]} returned {len(traces)} traces")
    k1_launches = _k1_calls(kernels) - k1_before
    if k1_launches < len(solves):
        problems.append(f"K1 launches in the load {k1_launches} below {len(solves)} solve "
                        f"records")
    if not capacity_view.get("sampled") or slo_view.get("kind") != "SLOReport":
        problems.append(f"capacity sampled {capacity_view.get('sampled')}, slo kind "
                        f"{slo_view.get('kind')}")
    if not profile_exists:
        problems.append(f"the device profile's directory {profile_dir} does not exist")
    if stacks[0] != 200 or "--- thread" not in stacks[1]:
        problems.append("/debug/stacks did not dump the threads")
    if rc != 0:
        problems.append(f"the command exited with {rc} on SIGTERM: {log}")
    if problems:
        fail(phase, "; ".join(problems))
    explain = re.findall(r'^scheduler_phase_seconds_(sum|count)\{phase="explain"\} ([0-9.e+]+)$',
                         metrics_body, re.M)
    explain = {k: float(v) for k, v in explain}
    explain_le = {le: float(v) for le, v in re.findall(
        r'^scheduler_phase_seconds_bucket\{phase="explain",le="([^"]+)"\} ([0-9.e+]+)$',
        metrics_body, re.M)}
    ticks = len(solves)
    return {
        "card": smi, "apiserver": " ".join(command), "scheduler": " ".join(sched.cmd),
        "nodes": DAEMON_NODES, "fitting_pods": DEBUG_FITTING, "stuck_pods": DEBUG_STUCK,
        "command_up_s": up_s, "bound_s": bound_s, "settle_s": settle_s,
        "ticks": ticks, "k1_launches": k1_launches, "k1_prewarm_launches": k1_before,
        "k1_ms_traced": k1_trace_ms or "not measured",
        "kernels_traced": dict(sorted(traced_kernels.items(), key=lambda kv: -kv[1][1])[:8]),
        "trace_s": DEBUG_TRACE_S, "trace_lead_s": DEBUG_TRACE_LEAD_S,
        "explain_phases": explain.get("count", 0.0), "explain_s": explain.get("sum", 0.0),
        "explain_s_per_phase": (explain["sum"] / explain["count"]) if explain.get("count")
        else None,
        "explain_phases_over_1s": explain.get("count", 0.0) - explain_le.get("1", 0.0),
        "explain_phases_over_2_5s": explain.get("count", 0.0) - explain_le.get("2.5", 0.0),
        "decisions": len(decisions), "bound_decision_events": bound_events,
        "tables_in_newest_bound_tick": len(tabled), "rebalance_sampled":
            rebalance_view.get("sampled"),
        "slo_verdict": slo_view.get("verdict"),
        "leg_s": time.perf_counter() - t_leg,
        "checks": {"healthz": "ok", "bound_decisions_at_binding": DEBUG_FITTING,
                   "stuck_unschedulable_with_tables": DEBUG_STUCK, "pod_filter": True,
                   "solve_records_cover_pods": True, "trace_names_pod": True,
                   "k1_launches_cover_solves": True, "capacity_sampled": True,
                   "device_profile_dir": True, "sigterm_exit_0": True},
        "timed": "host clock of this process; K1 ms a launch, in launch order, and the top "
                 "kernels by device ms from the command's own torch.profiler trace "
                 "(/debug/device-profile, after a first idle capture of 1 s) started "
                 "trace_lead_s before the load; explain from the command's /metrics",
    }


FAILOVER_ROUNDS = 2  # 5 before PR 16's cut, 3 before PR 17's
FAILOVER_PREWARM_BUCKETS = 128  # the command's default: the standby's warm launches
FAILOVER_SYNC_S = 120.0
FAILOVER_BIND_S = 60.0  # a round's pod's time to bind after the kill
HA_LEASE_S, HA_RENEW_S = 2.0, 0.5
HA_CMD_BIND_S = 180.0  # the rival command's lease wait, cold build and first tick
SCALAR_PODS = 32


def _k1_count():
    """K1's wrapper count: what a leg zeroes before its path and reads
    after it (a CPU dry run patches it to the ledger's plain calls)."""
    from kubernetes_tpu_torch.ops import scan_kernel

    return scan_kernel.scan_with_state.launches


def _k1_set(n=0):
    from kubernetes_tpu_torch.ops import scan_kernel

    scan_kernel.scan_with_state.launches = n


def _memory(torch, device):
    """Bytes the card's tensors hold, read once with the capacity plane
    idle: after every capacity warm-up thread (a daemon's start) has
    ended and a collection. The legs' daemons take no idle-tick sample
    (`_warm_standby`), and a caller waits out a tick's own sample
    (`_await_sample`) first, so no sample's short-lived tensors count."""
    for t in threading.enumerate():
        if t.name == "capacity-warm":
            t.join(timeout=30)
    gc.collect()
    if device.type != "cuda":
        return 0
    torch.cuda.synchronize()
    return torch.cuda.memory_allocated(device)


def _await_sample(phase, daemon, since, timeout=30.0):
    """Wait until `daemon` took a capacity sample after monotonic second
    `since`: the one that ends its tick."""
    deadline = time.monotonic() + timeout
    while daemon._capacity_sampled_mono < since:
        if time.monotonic() > deadline:
            fail(phase, f"no capacity sample within {timeout} s of the tick")
        time.sleep(0.005)


def _summary_totals(metric):
    """(count, sum) of an unlabelled summary so far."""
    s = metric._stats.get((), {})
    return s.get("count", 0), s.get("sum", 0.0)


def _wait_bound(phase, watch, name, timeout):
    """The first monotonic second the watch saw `name` bound, and the node."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        seen = [(at, node) for (n, _uid), nodes in list(watch.bound.items()) if n == name
                for node, at in dict(nodes).items()]
        if seen:
            return min(seen)
        time.sleep(0.002)
    fail(phase, f"pod {name} was not bound within {timeout} s")


def _placement(phase, client, pod_wire, device):
    """Where the card's schedule_backlog puts `pod_wire` on the cluster as
    LISTed now (its nodes in the LIST's order, which the informers keep).
    A comparison: K1's count is put back as it was."""
    from kubernetes_tpu_torch.models import serde
    from kubernetes_tpu_torch.models.objects import Pod
    from kubernetes_tpu_torch.scheduler.batch import schedule_backlog

    _, pods, nodes = _listed(client)
    k = _k1_count()
    try:
        return schedule_backlog([serde.from_wire(Pod, pod_wire)], nodes,
                                [p for p in pods if p.spec.node_name], device=device)[0]
    finally:
        _k1_set(k)


def _warm_standby(url, device):
    """A WarmStandbyScheduler over its own HTTP client whose daemon
    prewarms as the command's does (FAILOVER_PREWARM_BUCKETS). Its idle
    ticks take no capacity sample (the quiet cluster's series are not
    what these legs measure), so device memory reads between ticks see
    no sample's tensors; each solving tick still samples."""
    from kubernetes_tpu_torch.client.rest import Client, HTTPTransport
    from kubernetes_tpu_torch.scheduler.daemon import IncrementalBatchScheduler
    from kubernetes_tpu_torch.scheduler.standby import WarmStandbyScheduler

    def daemon(cfg):
        d = IncrementalBatchScheduler(cfg, device=device, prewarm_buckets=FAILOVER_PREWARM_BUCKETS)
        d.CAPACITY_IDLE_REFRESH_S = math.inf
        return d

    return WarmStandbyScheduler(Client(HTTPTransport(url)), sync_timeout=FAILOVER_SYNC_S,
                                daemon_factory=daemon)


def run_daemon_failover(torch, device, smi):
    """Leg daemon_failover: `bench.py:947-1024`'s warm failover drill at
    5,000 nodes and 5,000 bound pods over the apiserver child. A started
    WarmStandbyScheduler binds a warm-up pod; then in each of
    FAILOVER_ROUNDS rounds a fresh standby is prewarmed (informers
    synced, session built on the card with its warm launches), the
    active one killed, one pod created and the standby activated. Kill
    to that pod's bind on this process's watch, the prewarm's split, K1
    launches by the prewarm and by the first tick, K1 ms on the first
    tick by CUDA events, device memory after each round. Enforced: every
    round's pod bound once, at the node the card's schedule_backlog
    gives on the LISTed cluster; no pod bound twice; the memory after
    each round within two live sessions' worth (one measured after the
    warm-up tick: the session, its tick staging and the kernels'
    caches)."""
    from kubernetes_tpu_torch.client.rest import Client, HTTPTransport
    from kubernetes_tpu_torch.utils import capacity, slo

    phase = "daemon_failover"
    t_leg = time.perf_counter()
    capacity.DEFAULT.reset()
    with ControlPlane(phase) as cp:
        client = Client(HTTPTransport(cp.url))
        _cluster(phase, client, pods=DAEMON_NODES)
        _, version = client.list_wire("pods", namespace="default")
        watch = _PodWatch(cp.url, version)

        standby = functools.partial(_warm_standby, cp.url, device)
        active = None
        try:
            mem0 = _memory(torch, device)
            _k1_set()
            active = standby()
            active.prewarm()
            t_up = time.monotonic()
            active.activate()
            client.create("pods", _daemon_pod_wire("failover-warmup"), namespace="default")
            _wait_bound(phase, watch, "failover-warmup", FAILOVER_BIND_S)
            _await_sample(phase, active.daemon, t_up)
            # A live session's worth: its state, the staging its ticks
            # keep, and the kernels' caches.
            session_bytes = _memory(torch, device) - mem0
            rounds = []
            for r in range(FAILOVER_ROUNDS):
                name = f"failover-r{r}"
                wire = _daemon_pod_wire(name)
                k0 = _k1_count()
                mem_one = _memory(torch, device)
                sb = standby()
                sb.prewarm()
                k_prewarm = _k1_count() - k0
                mem_two = _memory(torch, device)
                want = _placement(phase, client, wire, device)
                k1 = _k1_count()
                active.kill()
                t0 = time.monotonic()
                client.create("pods", wire, namespace="default")
                with _K1Events(torch) as ev:
                    sb.activate()
                    at, node = _wait_bound(phase, watch, name, FAILOVER_BIND_S)
                    if device.type == "cuda":
                        torch.cuda.synchronize()
                k_tick = _k1_count() - k1
                k1_ms = [a.elapsed_time(b) for a, b in ev.events]
                active = sb
                _await_sample(phase, sb.daemon, t0)
                mem = _memory(torch, device)
                rounds.append({"kill_to_first_bind_s": at - t0, "node": node, "want": want,
                               "prewarm_sync_s": sb.sync_s, "prewarm_build_s": sb.build_s,
                               "k1_prewarm_launches": k_prewarm,
                               "k1_first_tick_launches": k_tick, "k1_ms": k1_ms,
                               "standby_bytes": mem_two - mem_one,
                               "memory_two_sessions": mem_two, "memory_after_round": mem})
            launches = _k1_count()
        finally:
            if active is not None:
                active.stop()
            watch.close()
        twice = watch.bound_twice()
        bound, _, _ = _listed(client)
        command = cp.cmd
    problems = []
    for r, row in enumerate(rounds):
        if row["node"] != row["want"] or bound.get(f"failover-r{r}") != row["want"]:
            problems.append(f"round {r}: bound at {row['node']} (LIST {bound.get(f'failover-r{r}')}), "
                            f"schedule_backlog says {row['want']}")
        if row["memory_after_round"] > mem0 + 2 * max(session_bytes, 1):
            problems.append(f"round {r}: {row['memory_after_round']} bytes on the card, past two "
                            f"sessions' worth ({mem0} + 2 x {session_bytes})")
        if row["k1_first_tick_launches"] < 1:
            problems.append(f"round {r}: the first tick launched K1 {row['k1_first_tick_launches']} "
                            f"times")
    if twice:
        problems.append(f"pods bound twice: {twice[:3]}")
    if problems:
        fail(phase, "; ".join(problems) + f"; rounds: {json.dumps(rounds)[:2000]}")
    samples = sorted(row["kill_to_first_bind_s"] for row in rounds)
    p50, p99 = samples[len(samples) // 2], samples[min(len(samples) - 1, int(len(samples) * 0.99))]
    obj = slo.BENCH_OBJECTIVES["failover_to_first_bind_s"]
    return {
        "card": smi, "apiserver": " ".join(command), "nodes": DAEMON_NODES,
        "bound_pods": DAEMON_NODES, "rounds": rounds,
        "kill_to_first_bind_p50_s": p50, "kill_to_first_bind_p99_s": p99,
        "slo_target_s": obj.target, "slo_verdict": slo.verdict_for_value(obj, p99),
        "slo_enforced": False, "session_bytes": session_bytes, "memory_before_bytes": mem0,
        "k1_launches": launches, "leg_s": time.perf_counter() - t_leg,
        "checks": {"each_round_bound_once_at_schedule_backlog": True, "no_pod_bound_twice": True,
                   "memory_within_two_sessions": True, "first_tick_launched_k1": True},
        "timed": "host clock of this process: the kill to the round pod's binding on this "
                 "process's watch; K1 ms by CUDA events around each launch from activation "
                 "to the bind",
    }


def run_daemon_ha(torch, device, smi):
    """Leg daemon_ha: two HAScheduler replicas in this process over the
    apiserver child (5,000 nodes, 5,000 bound pods), lease HA_LEASE_S,
    renew and retry HA_RENEW_S, each with a warm standby on the card.
    The leader binds a pod; then it is crashed (its elector stopped, its
    standby killed, no release) and one pod created: kill to its bind
    (the lease's expiry included) and the rival's grant to running
    (scheduler_standby_activation_seconds). The crashed replica is then
    deposed as its elector would (`_deposed`), which rebuilds a warm
    standby on the elector's thread (timed: it holds renewals).
    Enforced: at most one active daemon and one validated token at every
    sample, the token bumped across the takeover, the deposed replica
    warm and not active with no failed rebuild, every pod bound once."""
    import threading

    from kubernetes_tpu_torch.client.rest import Client, HTTPTransport
    from kubernetes_tpu_torch.scheduler import standby as standby_mod
    from kubernetes_tpu_torch.scheduler.standby import HAScheduler
    from kubernetes_tpu_torch.utils import capacity

    phase = "daemon_ha"
    t_leg = time.perf_counter()
    capacity.DEFAULT.reset()
    with ControlPlane(phase) as cp:
        client = Client(HTTPTransport(cp.url))
        _cluster(phase, client, pods=DAEMON_NODES)
        _, version = client.list_wire("pods", namespace="default")
        watch = _PodWatch(cp.url, version)

        standby = functools.partial(_warm_standby, cp.url, device)
        replicas = [HAScheduler(Client(HTTPTransport(cp.url)), name, lease_duration=HA_LEASE_S,
                                renew_period=HA_RENEW_S, retry_period=HA_RENEW_S,
                                standby_factory=standby) for name in ("ha-a", "ha-b")]
        samples, stop = [], threading.Event()

        def sampler():
            while not stop.wait(0.05):
                try:
                    valid = sum(r.lease.validate(r.token) for r in replicas)
                except Exception:  # a read that failed: the sample is skipped
                    continue
                samples.append((sum(r.daemon is not None for r in replicas), valid))

        _k1_set()
        t_sampler = threading.Thread(target=sampler, daemon=True)
        try:
            t0 = time.perf_counter()
            for r in replicas:
                r.start()  # each prewarms first, then stands for election
            start_s = time.perf_counter() - t0
            t_sampler.start()
            _wait(phase, "one leader", lambda: sum(r.daemon is not None for r in replicas) == 1,
                  timeout=60)
            leader = next(r for r in replicas if r.daemon is not None)
            rival = next(r for r in replicas if r is not leader)
            memory_two = _memory(torch, device)
            client.create("pods", _daemon_pod_wire("ha-before"), namespace="default")
            _wait_bound(phase, watch, "ha-before", FAILOVER_BIND_S)
            token = leader.token
            act0 = _summary_totals(standby_mod._ACTIVATION_LATENCY)
            want = _placement(phase, client, _daemon_pod_wire("ha-after"), device)
            leader.elector._stop.set()
            leader.standby.kill()
            t_kill = time.monotonic()
            client.create("pods", _daemon_pod_wire("ha-after"), namespace="default")
            at, node = _wait_bound(phase, watch, "ha-after", HA_LEASE_S + FAILOVER_BIND_S)
            act1 = _summary_totals(standby_mod._ACTIVATION_LATENCY)
            t_rebuild = time.perf_counter()
            leader._deposed()
            rebuild_s = time.perf_counter() - t_rebuild
            deposed_warm = (leader.standby is not None and leader.standby.warm
                            and not leader.standby.active)
            rival_token, failures = rival.token, leader.rebuild_failures
            time.sleep(4 * HA_RENEW_S)  # samples with the rebuilt standby resident
            memory_after = _memory(torch, device)
            launches = _k1_count()
        finally:
            stop.set()
            if t_sampler.is_alive():
                t_sampler.join(timeout=5)
            for r in replicas:
                try:
                    r.stop()
                except Exception:
                    pass
            watch.close()
        twice = watch.bound_twice()
        bound, _, _ = _listed(client)
        command = cp.cmd
    problems = []
    if any(a > 1 or v > 1 for a, v in samples) or not samples:
        problems.append(f"{sum(a > 1 or v > 1 for a, v in samples)} of {len(samples)} samples "
                        f"with two leaders")
    if not (rival_token and token and rival_token > token):
        problems.append(f"token {token} -> {rival_token}: not bumped")
    if not deposed_warm or failures:
        problems.append(f"the deposed replica: warm and idle {deposed_warm}, {failures} failed "
                        f"rebuilds")
    if node != want or bound.get("ha-after") != want or not bound.get("ha-before"):
        problems.append(f"ha-after bound at {node} (LIST {bound.get('ha-after')}), "
                        f"schedule_backlog says {want}; ha-before at {bound.get('ha-before')}")
    if twice:
        problems.append(f"pods bound twice: {twice[:3]}")
    if problems:
        fail(phase, "; ".join(problems))
    activations = act1[0] - act0[0]
    return {
        "card": smi, "apiserver": " ".join(command), "nodes": DAEMON_NODES,
        "bound_pods": DAEMON_NODES, "lease_s": HA_LEASE_S, "renew_s": HA_RENEW_S,
        "replicas_start_s": start_s, "kill_to_first_bind_s": at - t_kill,
        "grant_to_running_s": (act1[1] - act0[1]) / activations if activations else None,
        "activations": activations, "token_before": token, "token_after": rival_token,
        "deposed_rebuild_s": rebuild_s, "samples": len(samples),
        "memory_two_sessions_bytes": memory_two, "memory_after_rebuild_bytes": memory_after,
        "k1_launches": launches, "leg_s": time.perf_counter() - t_leg,
        "checks": {"at_most_one_leader_each_sample": True, "token_bumped": True,
                   "deposed_back_warm_not_active": True, "pods_bound_once": True,
                   "bound_at_schedule_backlog": True},
        "timed": "host clock of this process: the crash to ha-after's binding on this "
                 "process's watch (the lease's expiry included); grant to running from "
                 "scheduler_standby_activation_seconds; the deposed rebuild around _deposed()",
    }


def _lock_holder(client):
    """The kube-scheduler lock's holder annotation (None before it exists)."""
    from kubernetes_tpu_torch.client.rest import APIError

    try:
        wire = client.get_wire("endpoints", "kube-scheduler", namespace="kube-system")
    except APIError as e:
        if e.code == 404:
            return None
        raise
    return (wire.get("metadata", {}).get("annotations") or {}).get(
        "leaderelection.kubernetes-tpu.io/holder")


def run_daemon_ha_cmd(torch, device, smi):
    """Leg daemon_ha_cmd: two children of `python -m
    kubernetes_tpu_torch.cmd.scheduler --batch --leader-elect
    --leader-elect-identity a|b` against the apiserver child (5,000
    nodes, 5,000 bound pods). `a` leads and binds a pod; it is killed
    with SIGKILL and a pod created: kill to that pod's bind, split into
    the wait for the lock (5 s lease) and `b`'s cold start (LIST,
    session, prewarm) and first tick, beside daemon_failover's warm
    figure. Enforced: one holder in the kube-scheduler lock at every
    read, a then b; every pod bound once; b's /healthz 200."""
    import threading

    from kubernetes_tpu_torch.client.rest import Client, HTTPTransport

    phase = "daemon_ha_cmd"
    t_leg = time.perf_counter()
    with ControlPlane(phase) as cp:
        client = Client(HTTPTransport(cp.url))
        _cluster(phase, client, pods=DAEMON_NODES)
        _, version = client.list_wire("pods", namespace="default")
        watch = _PodWatch(cp.url, version)
        reads, stop = [], threading.Event()

        def sampler():
            reader = Client(HTTPTransport(cp.url))
            while not stop.wait(0.1):
                try:
                    reads.append((time.monotonic(), _lock_holder(reader)))
                except Exception:
                    continue

        elect = ["--leader-elect", "--leader-elect-identity"]
        a = _Scheduler(phase, cp.url, device, extra=elect + ["a"])
        b = None
        t_sampler = threading.Thread(target=sampler, daemon=True)
        t_sampler.start()
        try:
            a.wait_up()
            _wait(phase, "a holding the lock", lambda: _lock_holder(client) == "a", timeout=60)
            k1_a = _settled_k1_calls(a)  # a's daemon built: its prewarm launches settled
            up_s = time.perf_counter() - t_leg
            b = _Scheduler(phase, cp.url, device, extra=elect + ["b"])
            b.wait_up()
            client.create("pods", _daemon_pod_wire("cmd-before"), namespace="default")
            _wait_bound(phase, watch, "cmd-before", FAILOVER_BIND_S)
            k1_b_idle = _k1_calls(b.get_json("/debug/kernels"))
            a.kill()
            t_kill = time.monotonic()
            client.create("pods", _daemon_pod_wire("cmd-after"), namespace="default")
            at, node = _wait_bound(phase, watch, "cmd-after", HA_CMD_BIND_S)
            health = b.get("/healthz")
            k1_b = _k1_calls(b.get_json("/debug/kernels"))
            rc = b.terminate()
        finally:
            stop.set()
            t_sampler.join(timeout=5)
            a.kill()
            if b is not None:
                b.kill()
            watch.close()
        twice = watch.bound_twice()
        bound, _, _ = _listed(client)
        command = cp.cmd
    holders = [h for _, h in reads if h is not None]
    changes = [h for i, h in enumerate(holders) if i == 0 or h != holders[i - 1]]
    took = next((t for t, h in reads if h == "b"), None)
    problems = []
    if changes != ["a", "b"] or any(not isinstance(h, str) or not h for h in holders):
        problems.append(f"the lock's holders in order: {changes}")
    if not bound.get("cmd-before") or bound.get("cmd-after") != node:
        problems.append(f"bindings: cmd-before {bound.get('cmd-before')}, cmd-after "
                        f"{bound.get('cmd-after')} (watch {node})")
    if twice:
        problems.append(f"pods bound twice: {twice[:3]}")
    if health != (200, "ok"):
        problems.append(f"b's /healthz answered {health}")
    if k1_b_idle != 0 or k1_b < 1:
        problems.append(f"b's K1 launches: {k1_b_idle} while a led, {k1_b} after")
    if problems:
        fail(phase, "; ".join(problems) + f": {b.tail() if b else ''}")
    return {
        "card": smi, "apiserver": " ".join(command), "scheduler": " ".join(a.cmd),
        "nodes": DAEMON_NODES, "bound_pods": DAEMON_NODES, "lease_s": 5.0,
        "a_up_s": up_s, "kill_to_first_bind_s": at - t_kill,
        "lock_wait_s": (took - t_kill) if took else None,
        "cold_start_to_bind_s": (at - took) if took else None,
        "k1_prewarm_launches_a": k1_a, "k1_launches_b": k1_b, "lock_reads": len(reads),
        "b_exit_code_on_sigterm": rc, "leg_s": time.perf_counter() - t_leg,
        "checks": {"one_holder_each_read": True, "holders_a_then_b": True,
                   "pods_bound_once": True, "b_healthz_200": True},
        "timed": "host clock of this process: SIGKILL of a to cmd-after's binding on this "
                 "process's watch; the lock read every 0.1 s (b's takeover to that resolution)",
    }


def run_daemon_scalar(torch, device, smi):
    """Leg daemon_scalar: the per-pod Scheduler in this process over the
    apiserver child, SCALAR_PODS pods (every eighth with a zone selector)
    on 5,000 nodes, one schedule_one() a pod, not started. Pods a second.
    Enforced: its bindings, in the order it popped the pods, equal the
    card's schedule_backlog of those pods in that order on the cluster
    LISTed before; the per-pod path launched no K1."""
    import copy

    from kubernetes_tpu_torch.client.rest import Client, HTTPTransport
    from kubernetes_tpu_torch.scheduler.batch import schedule_backlog
    from kubernetes_tpu_torch.scheduler.daemon import Scheduler, SchedulerConfig

    phase = "daemon_scalar"
    t_leg = time.perf_counter()
    with ControlPlane(phase) as cp:
        client = Client(HTTPTransport(cp.url))
        _cluster(phase, client)
        _bulk(phase, lambda xs: client.create_bulk("pods", xs, namespace="default"),
              [_daemon_pod_wire(f"s{i}", zone=f"z{i % 4}" if i % 8 == 0 else None)
               for i in range(SCALAR_PODS)])
        _, pods, nodes = _listed(client)
        cfg = SchedulerConfig(Client(HTTPTransport(cp.url)), raw_scheduled_cache=False).start()
        try:
            if not cfg.wait_for_sync(60):
                fail(phase, "the daemon's caches did not sync")
            _wait(phase, "the pods in the queue", lambda: len(cfg.pod_queue) == SCALAR_PODS)
            d = Scheduler(cfg)
            order = []
            schedule = cfg.algorithm.schedule

            def logged(pod, lister):
                order.append(pod.metadata.name)
                return schedule(pod, lister)

            cfg.algorithm.schedule = logged
            _k1_set()
            t0 = time.perf_counter()
            steps = sum(d.schedule_one(timeout=1.0) for _ in range(SCALAR_PODS))
            wall = time.perf_counter() - t0
            launches = _k1_count()
            d.stop()
        finally:
            cfg.stop()
        bound, _, _ = _listed(client)
        command = cp.cmd
    by_name = {p.metadata.name: p for p in pods}
    pending = [copy.deepcopy(by_name[n]) for n in order]
    want = schedule_backlog(pending, nodes, device=device)
    got = [bound.get(n) for n in order]
    _same(phase, pending, got, want, "the card's schedule_backlog in the pop order")
    if steps != SCALAR_PODS or len(order) != SCALAR_PODS or launches:
        fail(phase, f"{steps} steps, {len(order)} pods scheduled, {launches} K1 launches")
    return {
        "card": smi, "apiserver": " ".join(command), "nodes": DAEMON_NODES, "pods": SCALAR_PODS,
        "placed": sum(n is not None for n in got), "wall_s": wall, "pods_per_s": SCALAR_PODS / wall,
        "k1_launches": launches, "leg_s": time.perf_counter() - t_leg,
        "equal_to_schedule_backlog": True,
        "timed": "host clock of this process around the 32 schedule_one() calls (the scalar "
                 "plugins over every Ready node and one POST a bind)",
    }


DURABLE_CREATES = 256  # pods created one at a time in each store mode


def _create_latencies(phase, url, n, prefix):
    """Seconds of `n` single pod creates over HTTP, one after another."""
    from kubernetes_tpu_torch.client.rest import Client, HTTPTransport

    client = Client(HTTPTransport(url))
    out = []
    for i in range(n):
        t0 = time.perf_counter()
        client.create("pods", _daemon_pod_wire(f"{prefix}{i}"), namespace="default")
        out.append(time.perf_counter() - t0)
    return out


def _raw_list(url, path):
    """A LIST's items in wire form, by name, with the list's version."""
    import urllib.request

    with urllib.request.urlopen(url + path, timeout=60) as resp:
        body = json.loads(resp.read())
    return ({o["metadata"]["name"]: o for o in body["items"]},
            int(body["metadata"]["resourceVersion"]))


def _filesystem_of(path):
    """The type and mount point of the filesystem that holds `path`, from
    /proc/mounts (the longest mount point that is a prefix of it)."""
    path = os.path.realpath(path)
    best = ("unknown", "")
    try:
        with open("/proc/mounts") as f:
            for line in f:
                fields = line.split()
                if len(fields) < 3:
                    continue
                mnt = fields[1].replace("\\040", " ")
                inside = path == mnt or path.startswith(mnt.rstrip("/") + "/")
                if inside and len(mnt) >= len(best[1]):
                    best = (fields[2], mnt)
    except OSError:
        pass
    return {"type": best[0], "mount": best[1]}


def run_apiserver_durable(torch, device, smi):
    """Leg apiserver_durable: the port's apiserver with a durable store
    (`--data-dir`, fsync before every ack) under 5,000 nodes and the
    daemon_parity leg's 1,024 pods bound by one schedule_batch() on the
    card, then SIGKILLed and restarted on the same directory. Every
    node, pod and binding LISTed after the restart equals the LIST
    before the kill, and the next write's resourceVersion is above the
    last acked one. Reports the create p50 and p99 with fsync (after the
    restart) and in memory (a child with the store in memory that holds
    the same 5,000 nodes and 1,024 pods, unbound), DURABLE_CREATES single
    pod creates each, the restart's seconds to /healthz, the WAL and
    snapshot bytes at the kill, and the type of the filesystem that holds
    the data directory. The SIGKILL leaves the page cache whole, so the
    read-back shows that the process acked only what it had written, not
    that it reached the disk."""
    import copy
    import tempfile

    from kubernetes_tpu_torch.client.rest import Client, HTTPTransport
    from kubernetes_tpu_torch.ops import scan_kernel
    from kubernetes_tpu_torch.scheduler.batch import schedule_backlog
    from kubernetes_tpu_torch.scheduler.daemon import IncrementalBatchScheduler, SchedulerConfig

    phase = "apiserver_durable"
    with ControlPlane(phase) as cp:
        client = Client(HTTPTransport(cp.url))
        _cluster(phase, client)
        _bulk(phase, lambda xs: client.create_bulk("pods", xs, namespace="default"),
              [_parity_pod(i, False) for i in range(DAEMON_PARITY_PODS)])
        memory_creates = _create_latencies(phase, cp.url, DURABLE_CREATES, "mem")
    data_dir = tempfile.mkdtemp(prefix="apiserver-durable-")
    filesystem = _filesystem_of(data_dir)
    try:
        with ControlPlane(phase, data_dir=data_dir) as cp:
            probe = cp.cuda_probe
            client = Client(HTTPTransport(cp.url))
            _cluster(phase, client)
            pods = [_parity_pod(i, False) for i in range(DAEMON_PARITY_PODS)]
            _bulk(phase, lambda xs: client.create_bulk("pods", xs, namespace="default"), pods)
            cfg = SchedulerConfig(Client(HTTPTransport(cp.url))).start()
            try:
                if not cfg.wait_for_sync(60):
                    fail(phase, "the daemon's caches did not sync")
                _wait(phase, "the pending pods in the queue",
                      lambda: len(cfg.pod_queue) == DAEMON_PARITY_PODS)
                q = cfg.pod_queue
                pending = copy.deepcopy([q._items[k] for k in q._queue if k in q._items])
                nodes = cfg.nodes.store.list()
                daemon = IncrementalBatchScheduler(cfg, max_batch=len(pending), device=device)
                scan_kernel.scan_with_state.launches = 0
                took = daemon.schedule_batch(timeout=1.0)
                launches = scan_kernel.scan_with_state.launches
                errors = daemon.device_errors
                daemon.stop()
            finally:
                cfg.stop()
            before_nodes, _ = _raw_list(cp.url, "/api/v1/nodes")
            before_pods, acked = _raw_list(cp.url, "/api/v1/namespaces/default/pods")
            files = {f: os.path.getsize(os.path.join(data_dir, f)) for f in os.listdir(data_dir)}
            cp.kill()
            t0 = time.perf_counter()
            cp.restart()
            recovery_s = time.perf_counter() - t0
            after_nodes, _ = _raw_list(cp.url, "/api/v1/nodes")
            after_pods, _ = _raw_list(cp.url, "/api/v1/namespaces/default/pods")
            probe_after = cp.cuda_probe
            nxt = Client(HTTPTransport(cp.url)).create(
                "pods", _daemon_pod_wire("after-restart"), namespace="default")
            next_version = int(nxt.metadata.resource_version)
            fsync_creates = _create_latencies(phase, cp.url, DURABLE_CREATES, "fs")
    finally:
        shutil.rmtree(data_dir, ignore_errors=True)
    if took != len(pending) or launches != 1 or errors:
        fail(phase, f"the tick took {took} of {len(pending)} pods with {launches} K1 launches "
                    f"and {errors} errors")
    bound = {n: (o.get("spec") or {}).get("nodeName") or None for n, o in before_pods.items()}
    ref = schedule_backlog(pending, nodes, device=device)
    got = [bound[p.metadata.name] for p in pending]
    diff = [i for i, (a, b) in enumerate(zip(got, ref)) if a != b]
    if diff or len(ref) != len(got):
        i = diff[0] if diff else 0
        fail(phase, f"the bindings differ from schedule_backlog on {len(diff)} pods; first "
                    f"{pending[i].metadata.name}: {got[i]} != {ref[i]}")
    for what, a, b in (("nodes", before_nodes, after_nodes), ("pods", before_pods, after_pods)):
        if a != b:
            lost = sorted(set(a) - set(b))[:3]
            changed = sorted(k for k in set(a) & set(b) if a[k] != b[k])[:3]
            fail(phase, f"the {what} LISTed after the restart differ: {len(a)} before, {len(b)} "
                        f"after, missing {lost}, changed {changed}")
    if next_version <= acked:
        fail(phase, f"the first write after the restart got resourceVersion {next_version}, "
                    f"not above the last acked {acked}")
    return {
        "card": smi, "apiserver": " ".join(cp.cmd), "nodes": len(after_nodes),
        "pods": len(after_pods), "bound": sum(v is not None for v in bound.values()),
        "equal_to_schedule_backlog": True, "lists_equal_after_restart": True,
        "last_acked_version": acked, "next_version": next_version,
        "create_s_fsync": {"p50": _percentile(fsync_creates, 50),
                           "p99": _percentile(fsync_creates, 99), "n": len(fsync_creates)},
        "create_s_memory": {"p50": _percentile(memory_creates, 50),
                            "p99": _percentile(memory_creates, 99), "n": len(memory_creates)},
        "recovery_s": recovery_s, "data_dir_bytes": files, "data_dir_filesystem": filesystem,
        "apiserver_cuda_context": {"before": probe, "after_restart": probe_after},
        "k1_launches": launches,
    }


# ---------------------------------------------------------------------------
# The replicated control plane and the controller-manager
# ---------------------------------------------------------------------------

#: The program each replica of leg apiserver_replicated runs
#: (`sys.executable -c REPLICA_LAUNCHER role name port data_dir leader_url
#: inflight`): the port's store on a durable data directory with fsync
#: before every ack, a `ReplicationHub` (role `leader`) or a
#: `FollowerReplica` that forwards writes to `leader_url`, and the port's
#: `APIHTTPServer` on `port`, assembled as the JAX package's replication
#: tests assemble theirs. It prints one JSON line when it serves, then
#: answers each line read from stdin with one JSON line, the replication
#: status: `follow NAME URL` adds a follower over `HTTPLink` (an empty one,
#: bootstrapped with the store's state), `rejoin NAME URL` adds one that
#: already holds this store's log (no bootstrap), `promote` makes this
#: follower the leader and attaches a new hub, `leader URL` points its
#: write forward elsewhere, `status` only reads.
REPLICA_LAUNCHER = r"""
import json
import sys

from kubernetes_tpu_torch.server.api import APIServer
from kubernetes_tpu_torch.server.httpserver import APIHTTPServer
from kubernetes_tpu_torch.store.kvstore import KVStore
from kubernetes_tpu_torch.store.replication import FollowerReplica, HTTPLink, ReplicationHub

role, name, port, data_dir, leader_url, inflight = sys.argv[1:7]
store = KVStore(data_dir=data_dir, fsync=True)
if role == "leader":
    api = APIServer(store=store)
    api.replication = ReplicationHub(store, name=name).attach()
else:
    replica = FollowerReplica(store=store, name=name)
    api = APIServer(store=replica.store)
    api.replication = replica
    api.leader_url = leader_url
server = APIHTTPServer(api, port=int(port), max_in_flight=int(inflight)).start()
print(json.dumps({"serving": server.address}), flush=True)
for line in sys.stdin:
    command, _, arg = line.strip().partition(" ")
    if command in ("follow", "rejoin"):
        follower, url = arg.split()
        api.replication.add_follower(HTTPLink(url, name=follower),
                                     bootstrap=command == "follow")
    elif command == "promote":
        promoted = api.replication.promote()
        api.leader_url = ""
        api.replication = ReplicationHub(promoted, name=name).attach()
    elif command == "leader":
        api.leader_url = arg
    elif command != "status":
        print(json.dumps({"error": "unknown command " + command}), flush=True)
        continue
    print(json.dumps(api.replication.status()), flush=True)
server.stop()
"""

REPL_CREATES = 256  # single pods created one at a time through a follower
REPL_MORE_PODS = 64  # pods created and bound after the failover
REPL_COMMAND_S = 60.0  # a replica's answer to one command (a bootstrap ships the whole state)
CM_UP_S = 60.0
RC_COUNT = 10
RC_REPLICAS = 500
RC_SCALED = 100  # the replicas of the RC scaled down
RC_BIND_S = 180.0
NODE_LOSS_NODES = 16
NODE_LOSS_REPLICAS = 32
NODE_LOSS_GRACE_S = 4.0
NODE_LOSS_EVICTION_S = 2.0
HEARTBEAT_S = 1.0
NODE_LOSS_WAIT_S = 60.0


class ReplicaChild(ControlPlane):
    """One replica of the port's replicated apiserver, a child running
    REPLICA_LAUNCHER: up when it answers /healthz (then no CUDA context),
    `command(line)` writes one line to its stdin and returns its JSON
    answer."""

    what = "replica"

    def __init__(self, phase, role, name, data_dir, leader_url=""):
        import queue

        self.phase = phase
        self.port = _free_port()
        self.url = f"http://127.0.0.1:{self.port}"
        self.name = name
        self.cmd = [sys.executable, "-c", REPLICA_LAUNCHER, role, name, str(self.port), data_dir,
                    leader_url, str(APISERVER_INFLIGHT)]
        self._lines = queue.Queue()
        self._spawn()

    def _spawn(self):
        import tempfile

        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(p for p in (REPO, env.get("PYTHONPATH")) if p)
        self._log = tempfile.TemporaryFile()
        self.proc = subprocess.Popen(self.cmd, cwd=REPO, env=env, stdin=subprocess.PIPE,
                                     stdout=subprocess.PIPE, stderr=self._log,
                                     start_new_session=True, text=True)
        threading.Thread(target=self._read, args=(self.proc.stdout,), daemon=True).start()

    def _read(self, stream):
        for line in stream:
            self._lines.put(line)

    def command(self, line):
        import queue

        t0 = time.perf_counter()
        self.proc.stdin.write(line + "\n")
        self.proc.stdin.flush()
        while True:
            try:
                out = json.loads(self._lines.get(timeout=REPL_COMMAND_S))
            except queue.Empty:
                fail(self.phase, f"replica {self.name} did not answer {line!r} in "
                                 f"{REPL_COMMAND_S} s: {self.tail()}")
            if "serving" not in out:
                break
        if "error" in out:
            fail(self.phase, f"replica {self.name}: {out['error']}")
        out["command_s"] = time.perf_counter() - t0
        return out


class ControllerManagerChild(ControlPlane):
    """`python -m kubernetes_tpu_torch.cmd.hyperkube controller-manager`
    as a child against the apiserver at `server`: up when its own
    /healthz (on its --healthz-port) answers 200, then no CUDA context."""

    what = "controller-manager"

    def __init__(self, phase, server, grace_s=None, eviction_s=None):
        self.phase = phase
        self.port = _free_port()
        self.url = f"http://127.0.0.1:{self.port}"
        self.cmd = [sys.executable, "-m", "kubernetes_tpu_torch.cmd.hyperkube",
                    "controller-manager", "--server", server, "--healthz-port", str(self.port)]
        if grace_s is not None:  # else the command's defaults
            self.cmd += ["--node-grace-period", str(grace_s),
                         "--node-eviction-timeout", str(eviction_s)]
        self._spawn()


def _pods_wire(url, selector=""):
    """The default namespace's pods in wire form, by name (`selector`: a
    label selector)."""
    from urllib.parse import quote

    query = "?labelSelector=" + quote(selector) if selector else ""
    return _raw_list(url, "/api/v1/namespaces/default/pods" + query)[0]


def _replication_status(url):
    import urllib.request

    with urllib.request.urlopen(url + "/replication/status", timeout=30) as resp:
        return json.loads(resp.read())


def run_apiserver_replicated(torch, device, smi):
    """Leg apiserver_replicated: the port's apiserver as a leader and two
    followers, each a child running REPLICA_LAUNCHER on a durable data
    directory with fsync before every ack, the leader's hub shipping to
    both over HTTPLink. 5,000 nodes and daemon_parity's 1,024 pods are
    created through follower f1 (every write forwarded to the leader and
    acked at quorum); the incremental daemon on the card, its transport
    listing f1, f2 and the leader, binds them in one schedule_batch():
    the bindings equal schedule_backlog's, and the three replicas' LISTs
    are equal. Before the daemon starts, REPL_CREATES single pods created
    and deleted one at a time through f1 time the forwarded write. Then,
    with both followers caught up, the leader is SIGKILLed; a write
    through f2, still pointing at it, fails at once; f1 is promoted with
    a new hub and f2 (holding the same log) as its follower, f2 forwards to
    f1; REPL_MORE_PODS pods are created through a client of the same
    endpoints starting at f2 and bound by the next schedule_batch().
    Every binding acked before the kill is on f1, and f1's and f2's LISTs
    are equal at the end. No replica holds a CUDA context."""
    import copy
    import tempfile

    from kubernetes_tpu_torch.client.rest import APIError, Client, HTTPTransport
    from kubernetes_tpu_torch.scheduler.batch import schedule_backlog
    from kubernetes_tpu_torch.scheduler.daemon import IncrementalBatchScheduler, SchedulerConfig

    phase = "apiserver_replicated"
    t_leg = time.perf_counter()
    root = tempfile.mkdtemp(prefix="apiserver-replicated-")
    filesystem = _filesystem_of(root)
    leader = f1 = f2 = None
    try:
        leader = ReplicaChild(phase, "leader", "leader", os.path.join(root, "leader")).__enter__()
        f1 = ReplicaChild(phase, "follower", "f1", os.path.join(root, "f1"), leader.url).__enter__()
        f2 = ReplicaChild(phase, "follower", "f2", os.path.join(root, "f2"), leader.url).__enter__()
        probes = {r.name: r.cuda_probe for r in (leader, f1, f2)}
        for f in (f1, f2):
            leader.command(f"follow {f.name} {f.url}")
        client = Client(HTTPTransport(f1.url))
        t0 = time.perf_counter()
        _cluster(phase, client)
        pods = [_parity_pod(i, False) for i in range(DAEMON_PARITY_PODS)]
        _bulk(phase, lambda xs: client.create_bulk("pods", xs, namespace="default"), pods)
        setup_s = time.perf_counter() - t0
        # Forwarded single creates and deletes, timed while this process
        # is quiet (before the daemon, whose deferred work would share
        # its interpreter with the client's calls).
        creates, deletes = [], []
        for i in range(REPL_CREATES):
            t0 = time.perf_counter()
            client.create("pods", _daemon_pod_wire(f"fwd{i}"), namespace="default")
            creates.append(time.perf_counter() - t0)
        for i in range(REPL_CREATES):
            t0 = time.perf_counter()
            client.delete("pods", f"fwd{i}", namespace="default")
            deletes.append(time.perf_counter() - t0)
        endpoints = [f1.url, f2.url, leader.url]
        cfg = SchedulerConfig(Client(HTTPTransport(endpoints))).start()
        try:
            if not cfg.wait_for_sync(60):
                fail(phase, "the daemon's caches did not sync")
            _wait(phase, "the pending pods in the queue",
                  lambda: len(cfg.pod_queue) == DAEMON_PARITY_PODS)
            q = cfg.pod_queue
            pending = copy.deepcopy([q._items[k] for k in q._queue if k in q._items])
            nodes = cfg.nodes.store.list()
            daemon = IncrementalBatchScheduler(cfg, max_batch=len(pending), device=device)
            _k1_set()
            t0 = time.perf_counter()
            took = daemon.schedule_batch(timeout=1.0)
            bind_s = time.perf_counter() - t0
            first_launches = _k1_count()
            leader_version = leader.command("status")["version"]
            _wait(phase, "the followers at the leader's version", lambda: all(
                _replication_status(r.url)["version"] >= leader_version for r in (f1, f2)))
            lists = {r.name: (_raw_list(r.url, "/api/v1/nodes")[0], _pods_wire(r.url))
                     for r in (leader, f1, f2)}
            if not lists["leader"] == lists["f1"] == lists["f2"]:
                fail(phase, "the replicas' LISTs differ after the bind")
            acked = _pods_wire(leader.url)
            # The kill is taken in a steady state: both followers journaled
            # the leader's log and learned its commit index (a promotion
            # keeps exactly the committed prefix it learned).
            _wait(phase, "both followers at the leader's commit", lambda: all(
                f["acked"] == f["commitKnown"] == st["version"]
                for st in [leader.command("status")] for f in st["followers"]))
            # The leader dies; a write through f2, still forwarding to it,
            # fails at once.
            t_kill = time.perf_counter()
            leader.kill()
            t0 = time.perf_counter()
            try:
                Client(HTTPTransport(f2.url)).create(
                    "pods", _daemon_pod_wire("to-the-dead-leader"), namespace="default")
                fail(phase, "a write forwarded to the killed leader was acked")
            except APIError as e:
                dead_forward = {"code": e.code, "seconds": time.perf_counter() - t0}
            if dead_forward["code"] != 502 or dead_forward["seconds"] > 5.0:
                fail(phase, f"a write forwarded to the killed leader: {dead_forward}")
            promoted = f1.command("promote")
            # f2 holds the same log as the promoted f1 (the steady-state
            # kill): it rejoins without a bootstrap.
            f2_status = f2.command("status")
            if (f2_status["version"], f2_status["journaled"]) != (promoted["version"],) * 2:
                fail(phase, f"f2 ({f2_status}) and the promoted f1 ({promoted}) differ")
            rejoined = f1.command(f"rejoin f2 {f2.url}")
            f2.command(f"leader {f1.url}")
            rotating = Client(HTTPTransport([f2.url, f1.url, leader.url]))
            more = []
            first_write_s = None
            for i in range(REPL_MORE_PODS):
                t0 = time.perf_counter()
                rotating.create("pods", _daemon_pod_wire(f"after{i}"), namespace="default")
                more.append(time.perf_counter() - t0)
                if first_write_s is None:
                    first_write_s = time.perf_counter() - t_kill
            _wait(phase, "the pods created after the failover in the queue",
                  lambda: len(cfg.pod_queue) == REPL_MORE_PODS)
            t0 = time.perf_counter()
            took_after = daemon.schedule_batch(timeout=1.0)
            bind_after_s = time.perf_counter() - t0
            launches = _k1_count()
            lag_end = f1.command("status")
            errors = daemon.device_errors
            daemon.stop()
        finally:
            cfg.stop()
        f1_version = f1.command("status")["version"]
        _wait(phase, "f2 at f1's version",
              lambda: _replication_status(f2.url)["version"] >= f1_version)
        on_f1, on_f2 = _pods_wire(f1.url), _pods_wire(f2.url)
        probes_end = {r.name: _cuda_context_of(r.proc.pid) for r in (f1, f2)}
    finally:
        for r in (leader, f1, f2):
            if r is not None:
                r.stop()
        shutil.rmtree(root, ignore_errors=True)
    if took != len(pending) or first_launches < 1 or took_after != REPL_MORE_PODS or errors:
        fail(phase, f"ticks took {took} of {len(pending)} and {took_after} of {REPL_MORE_PODS} "
                    f"pods with {first_launches} K1 launches in the first and {errors} errors")
    if any(held for held, _ in probes_end.values()):
        fail(phase, f"a replica holds a CUDA context at the end: {probes_end}")
    bound = {n: (o.get("spec") or {}).get("nodeName") or None for n, o in lists["f1"][1].items()}
    _same(phase, pending, [bound[p.metadata.name] for p in pending],
          schedule_backlog(pending, nodes, device=device), "schedule_backlog")
    lost = [n for n, o in acked.items()
            if n not in on_f1 or (on_f1[n].get("spec") or {}).get("nodeName")
            != (o.get("spec") or {}).get("nodeName")]
    if lost:
        fail(phase, f"{len(lost)} pods acked before the kill are missing or moved on f1: {lost[:3]}")
    unbound = [f"after{i}" for i in range(REPL_MORE_PODS)
               if not (on_f1.get(f"after{i}", {}).get("spec") or {}).get("nodeName")]
    if unbound or on_f1 != on_f2:
        fail(phase, f"after the failover: {len(unbound)} new pods unbound, f1 and f2 LISTs "
                    f"{'equal' if on_f1 == on_f2 else 'differ'}")
    return {
        "card": smi, "replicas": {r.name: " ".join(r.cmd[3:]) for r in (leader, f1, f2)},
        "data_dir_filesystem": filesystem, "nodes": DAEMON_NODES, "pods": len(on_f1),
        "setup_s": setup_s, "equal_to_schedule_backlog": True, "lists_equal": True,
        "forwarded_create_s_quorum_fsync": {"p50": _percentile(creates, 50),
                                            "p99": _percentile(creates, 99), "n": len(creates)},
        "forwarded_delete_s_quorum_fsync": {"p50": _percentile(deletes, 50),
                                            "p99": _percentile(deletes, 99), "n": len(deletes)},
        "bind_s": bind_s, "bind_after_failover_s": bind_after_s,
        "forward_to_dead_leader": dead_forward,
        "promote_s": promoted["command_s"], "rejoin_f2_s": rejoined["command_s"],
        "kill_to_first_acked_write_s": first_write_s,
        "create_after_failover_s": {"p50": _percentile(more, 50), "p99": _percentile(more, 99),
                                    "n": len(more)},
        "follower_lag_versions_end": {f["name"]: f["lagVersions"] for f in lag_end["followers"]},
        "acked_before_kill_on_f1": len(acked), "k1_launches": launches,
        "replica_cuda_context": {"start": probes,
                                 "end": {k: v for k, (_, v) in probes_end.items()}},
        "leg_s": time.perf_counter() - t_leg,
        "timed": "host clock of this process: each forwarded create or delete one call through "
                 "f1 (forward, leader WAL fsync, quorum ack) before the daemon exists; the bind "
                 "the first schedule_batch() of this daemon (a leg run alone pays the process's "
                 "first explain capture there); the kill from SIGKILL to the first create acked "
                 "through the new leader; the creates after the failover with the daemon's "
                 "deferred work in this process",
    }


class _CreateBindWatch:
    """The default namespace's pods over the port's HTTP watch: for each
    pod incarnation the monotonic second it was first seen (its ADDED
    event here, the create stamp), first seen bound and first seen
    Running."""

    def __init__(self, url):
        from kubernetes_tpu_torch.client.rest import Client, HTTPTransport

        self.stream = Client(HTTPTransport(url)).watch("pods", namespace="default")
        self.seen = {}  # (name, uid) -> [first seen, first bound or None]
        self.running = {}  # (name, uid) -> first seen with phase Running
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        while not self._stop.is_set():
            ev = self.stream.next(timeout=0.5)
            if ev is None:
                if self.stream.closed:
                    return
                continue
            now = time.monotonic()
            meta = ev.object.get("metadata", {})
            key = (meta.get("name"), meta.get("uid"))
            rec = self.seen.setdefault(key, [now, None])
            if rec[1] is None and (ev.object.get("spec") or {}).get("nodeName"):
                rec[1] = now
            if key not in self.running and (ev.object.get("status") or {}).get(
                    "phase") == "Running":
                self.running[key] = now

    def close(self):
        self._stop.set()
        self.stream.close()
        self._thread.join(timeout=5)


def _rc_wire(name, replicas, cpu, mem="16Mi"):
    """An RC in the density test's shape (tests/test_density.py rc_wire)."""
    return {"kind": "ReplicationController", "metadata": {"name": name, "namespace": "default"},
            "spec": {"replicas": replicas, "selector": {"app": name},
                     "template": {"metadata": {"labels": {"app": name}},
                                  "spec": {"containers": [{"name": "c", "image": "pause",
                                                           "resources": {"limits": {
                                                               "cpu": cpu, "memory": mem}}}]}}}}


def _over_capacity(pods, nodes):
    """Nodes whose bound pods ask for more cpu, memory or pods than they have."""
    from kubernetes_tpu_torch.models.quantity import Quantity

    used = {}
    for p in pods.values():
        node = (p.get("spec") or {}).get("nodeName")
        if not node:
            continue
        u = used.setdefault(node, [0, 0, 0])
        for c in p["spec"]["containers"]:
            lim = (c.get("resources") or {}).get("limits") or {}
            u[0] += Quantity.from_string(lim.get("cpu", "0")).milli_value()
            u[1] += Quantity.from_string(lim.get("memory", "0")).value()
        u[2] += 1
    over = []
    for name, u in used.items():
        cap = nodes[name]["status"]["capacity"]
        have = (Quantity.from_string(cap["cpu"]).milli_value(),
                Quantity.from_string(cap["memory"]).value(), int(cap["pods"]))
        if any(a > b for a, b in zip(u, have)):
            over.append(name)
    return over


def run_controller_rc(torch, device, smi):
    """Leg controller_rc: the RC path at full width. The port's apiserver
    child with 5,000 nodes, `hyperkube controller-manager` as a child
    (grace and eviction 600 s: nothing heartbeats the nodes until the
    kubelet is ported, so the node lifecycle controller must not act
    within the leg), the incremental daemon started on the card, then
    RC_COUNT RCs of RC_REPLICAS replicas in the density test's shape
    (cpu so that every placement moves the score, 16Mi). Enforced: every
    replica bound, each RC's status.replicas RC_REPLICAS, no node over
    its capacity; then one RC scaled to RC_SCALED: its other pods are
    deleted and the rest stay bound. Reports the seconds from the first
    RC create to the last bind, bound pods a second, create (the pod's
    first sight on this process's watch) to bind p50 and p99, the
    controller-manager child's CPU seconds and K1's launches."""
    from kubernetes_tpu_torch.client.rest import Client, HTTPTransport
    from kubernetes_tpu_torch.scheduler.daemon import SchedulerConfig

    phase = "controller_rc"
    t_leg = time.perf_counter()
    total = RC_COUNT * RC_REPLICAS
    cpu = f"{max(100, 4000 // (max(1, total // DAEMON_NODES) * 2))}m"
    with ControlPlane(phase) as cp:
        client = Client(HTTPTransport(cp.url))
        _cluster(phase, client)
        with ControllerManagerChild(phase, cp.url, 600, 600) as cm:
            cfg = SchedulerConfig(Client(HTTPTransport(cp.url))).start()
            daemon = watch = None
            try:
                daemon = _started_daemon(phase, torch, device, cfg, 0)
                _k1_set()
                daemon.start()
                watch = _CreateBindWatch(cp.url)
                cpu0 = cm.cpu_seconds()
                t_first = time.monotonic()
                for i in range(RC_COUNT):
                    client.create("replicationcontrollers", _rc_wire(f"dense-{i}", RC_REPLICAS, cpu),
                                  namespace="default")

                def bound_count():
                    return sum(1 for _, b in list(watch.seen.values()) if b is not None)

                _wait(phase, f"{total} replicas bound", lambda: bound_count() >= total,
                      timeout=RC_BIND_S)
                lat = [b - a for a, b in list(watch.seen.values()) if b is not None]
                last_bind = max(b for _, b in list(watch.seen.values()) if b is not None)
                cm_cpu_s = cm.cpu_seconds() - cpu0

                def statuses():
                    rcs, _ = _raw_list(cp.url, "/api/v1/namespaces/default/replicationcontrollers")
                    return {n: (o.get("status") or {}).get("replicas") for n, o in rcs.items()}

                _wait(phase, "every RC's status.replicas", lambda: set(statuses().values()) == {
                    RC_REPLICAS}, timeout=60)
                pods = _pods_wire(cp.url)
                nodes = _raw_list(cp.url, "/api/v1/nodes")[0]
                over = _over_capacity(pods, nodes)
                unbound = [n for n, o in pods.items() if not (o.get("spec") or {}).get("nodeName")]
                if len(pods) != total or unbound or over:
                    fail(phase, f"{len(pods)} pods of {total}, {len(unbound)} unbound, "
                                f"{len(over)} nodes over capacity: {over[:3]}")
                # Scale one RC down.
                t0 = time.perf_counter()
                client.patch("replicationcontrollers", "dense-0",
                             {"spec": {"replicas": RC_SCALED}}, namespace="default")

                def scaled():
                    return list(_pods_wire(cp.url, "app=dense-0").values())

                _wait(phase, f"dense-0 at {RC_SCALED} pods", lambda: len(scaled()) == RC_SCALED,
                      timeout=60)
                scale_down_s = time.perf_counter() - t0
                _wait(phase, "dense-0's status.replicas", lambda: statuses()["dense-0"] == RC_SCALED,
                      timeout=30)
                left = scaled()
                kept_bound = all((o.get("spec") or {}).get("nodeName") for o in left)
                kept_same = all(o["metadata"]["name"] in pods
                                and pods[o["metadata"]["name"]]["spec"].get("nodeName")
                                == o["spec"].get("nodeName") for o in left)
                launches = _k1_count()
                errors = daemon.device_errors
                probe_end = _cuda_context_of(cm.proc.pid)
            finally:
                if watch is not None:
                    watch.close()
                if daemon is not None:
                    daemon.stop()
                cfg.stop()
            cm_cmd, cm_probe = cm.cmd, cm.cuda_probe
        command = cp.cmd
    if not (kept_bound and kept_same) or launches < 1 or errors or probe_end[0]:
        fail(phase, f"after the scale-down: kept pods bound {kept_bound}, on their nodes "
                    f"{kept_same}; {launches} K1 launches, {errors} errors, the "
                    f"controller-manager's CUDA probe {probe_end[1]}")
    return {
        "card": smi, "apiserver": " ".join(command), "controller_manager": " ".join(cm_cmd[2:]),
        "nodes": DAEMON_NODES, "rcs": RC_COUNT, "replicas": RC_REPLICAS, "cpu": cpu,
        "bound": total, "over_capacity": 0,
        "first_create_to_last_bind_s": last_bind - t_first,
        "bound_per_s": total / (last_bind - t_first),
        "create_to_bind_s": {"p50": _percentile(lat, 50), "p99": _percentile(lat, 99),
                             "n": len(lat)},
        "controller_manager_cpu_s": cm_cpu_s, "scale_down_s": scale_down_s,
        "scaled_to": RC_SCALED, "kept_bound": True, "k1_launches": launches,
        "controller_manager_cuda_context": {"start": cm_probe, "end": probe_end[1]},
        "leg_s": time.perf_counter() - t_leg,
        "timed": "host clock of this process; a pod's create is its first sight on this "
                 "process's watch of the default namespace, its bind the first event with a "
                 "nodeName",
    }


# ---------------------------------------------------------------------------
# The node side: kubelets and the proxy
# ---------------------------------------------------------------------------

#: The program of a hollow-node child (`sys.executable -c HOLLOW_LAUNCHER
#: server names cpu memory max_pods heartbeat_s sync_s`): one port
#: `Kubelet` on a `FakeRuntime` for each comma-separated node name, each
#: with its own HTTP client to the apiserver at `server`, started 8 at a
#: time (a start whose connection is reset is tried again). It prints one JSON line when every kubelet has started
#: (`started`, `start_s`), then answers each line read from stdin: `pods`
#: with {node: the pod uids its runtime holds}, `relists` with {node: the
#: LISTs its pod informer issued after the first, where any}, `stop`
#: stops them all and exits.
HOLLOW_LAUNCHER = r"""
import json
import sys
import time
from concurrent.futures import ThreadPoolExecutor

from kubernetes_tpu_torch.client.rest import Client, HTTPTransport
from kubernetes_tpu_torch.kubelet.agent import Kubelet
from kubernetes_tpu_torch.kubelet.runtime import FakeRuntime

server, names, cpu, memory, max_pods, heartbeat, sync = sys.argv[1:8]
t0 = time.monotonic()


def start(name):
    # A registration's POST is never retried by the client: a connection
    # the loaded apiserver resets is tried again here, a few times.
    for attempt in range(5):
        try:
            return name, Kubelet(Client(HTTPTransport(server)), name, runtime=FakeRuntime(),
                                 cpu=cpu, memory=memory, max_pods=int(max_pods),
                                 heartbeat_period=float(heartbeat),
                                 sync_period=float(sync)).start()
        except OSError:
            if attempt == 4:
                raise
            time.sleep(0.5 * (attempt + 1))


with ThreadPoolExecutor(8) as pool:
    kubelets = dict(pool.map(start, names.split(",")))
print(json.dumps({"started": len(kubelets), "start_s": time.monotonic() - t0}), flush=True)
for line in sys.stdin:
    command = line.strip()
    if command == "stop":
        break
    if command == "pods":
        print(json.dumps({n: sorted(k.runtime.list_pods()) for n, k in kubelets.items()}),
              flush=True)
    elif command == "relists":
        print(json.dumps({n: k.pods.reflector.list_count - 1 for n, k in kubelets.items()
                          if k.pods.reflector.list_count > 1}), flush=True)
    else:
        print(json.dumps({"error": "unknown command " + command}), flush=True)
for k in kubelets.values():
    k.stop()
"""

#: The program each pod of leg kubelet_service runs (`sys.executable -c
#: ECHO_LAUNCHER port`): an HTTP server on 127.0.0.1:port answering every
#: GET with its pod's name and the value of the secret mounted at
#: $KUBERNETES_VOLUMES_DIR/kubernetes.io~secret/secret/value. It prints
#: one line when it serves (the pod's log).
ECHO_LAUNCHER = r"""
import http.server
import os
import sys

port = int(sys.argv[1])
pod = os.environ["KUBERNETES_POD_NAME"]
path = os.path.join(os.environ["KUBERNETES_VOLUMES_DIR"], "kubernetes.io~secret", "secret",
                    "value")


class Echo(http.server.BaseHTTPRequestHandler):
    def log_message(self, *args):
        pass

    def do_GET(self):
        with open(path) as f:
            body = f"{pod} {f.read()}".encode()
        self.send_response(200)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)


server = http.server.ThreadingHTTPServer(("127.0.0.1", port), Echo)
print(f"serving {pod} on {port}", flush=True)
server.serve_forever()
"""

DENSITY_NODES = 100  # the reference's density goal: 100 nodes, 30 pods a node
DENSITY_PODS = 3000
DENSITY_SCALED = 1500
DENSITY_CPU = "100m"  # tests/test_density.py: max(100, 4000 // (30 * 2)) m
DENSITY_MEM = "16Mi"
DENSITY_WAIT_S = 240.0
DENSITY_SLO_S = 5.0  # 99% of pod startups under 5 s (reported, not enforced)
#: density.go's pass bar: pods with events outside the normal start
#: sequence, at most 1% of the pods.
ABNORMAL_REASONS = ("Failed", "FailedScheduling", "Unhealthy", "ContainerKilled")
KUBELET_UP_S = 60.0
SERVICE_PODS = 3
SERVICE_REQUESTS = 30
SERVICE_AFTER = 20
SERVICE_WAIT_S = 60.0


def _maps_of(pid):
    """Whether process `pid` maps libcuda or libtorch (/proc/<pid>/maps)."""
    try:
        with open(f"/proc/{pid}/maps") as f:
            maps = f.read()
    except OSError:
        return {"read": False}
    return {"read": True, "libcuda": "libcuda.so" in maps, "libtorch": "libtorch" in maps}


def _loopback_and_mounts():
    """The host's local IPv4 addresses and the mount table, read only: a
    leg must leave both as it found them. The addresses are the host
    routes of `/proc/net/fib_trie`, else `ip -o -4 addr show`'s; on a
    machine with neither, None (the portal code installs an address
    only by running `ip`, so it cannot have installed one there)."""
    local = None
    if os.path.exists("/proc/net/fib_trie"):
        with open("/proc/net/fib_trie") as f:
            lines = f.read().splitlines()
        local = sorted({prev.split()[-1] for prev, line in zip(lines, lines[1:])
                        if line.strip() == "/32 host LOCAL"})
    elif shutil.which("ip"):
        out = subprocess.run(["ip", "-o", "-4", "addr", "show"], capture_output=True, text=True,
                             timeout=30).stdout
        local = sorted(line.split()[3] for line in out.splitlines() if len(line.split()) > 3)
    try:
        with open("/proc/mounts") as f:
            mounts = f.read()
    except OSError:
        mounts = None
    return local, mounts


class HollowNodes(ReplicaChild):
    """Port kubelets on `FakeRuntime`, one child running HOLLOW_LAUNCHER
    against the apiserver at `server`: up when it reports every kubelet
    started, then it must map neither libcuda nor libtorch;
    `command("pods")` returns {node: pod uids in its runtime}."""

    what = "hollow-node child"

    def __init__(self, phase, server, names, cpu="4", memory="8Gi", max_pods=110,
                 heartbeat_s=5.0, sync_s=3.0):
        import queue

        self.phase = phase
        self.name = names[0] if len(names) == 1 else f"{names[0]}..{names[-1]}"
        self.cmd = [sys.executable, "-c", HOLLOW_LAUNCHER, server, ",".join(names), cpu, memory,
                    str(max_pods), str(heartbeat_s), str(sync_s)]
        self._lines = queue.Queue()
        self._spawn()

    def pods(self):
        """{node: the pod uids its kubelet's runtime holds}."""
        out = self.command("pods")
        out.pop("command_s")
        return out

    def relists(self):
        """{node: LISTs its pod informer issued after the first}, where any
        (a watch the apiserver dropped, or one that failed)."""
        out = self.command("relists")
        out.pop("command_s")
        return out

    def __enter__(self):
        import queue

        try:
            line = json.loads(self._lines.get(timeout=KUBELET_UP_S))
        except queue.Empty:
            self.stop()
            fail(self.phase, f"the {self.what} {self.name} did not start its kubelets in "
                             f"{KUBELET_UP_S} s: {self.tail()}")
        self.start_s = line["start_s"]
        self.maps = _maps_of(self.proc.pid)
        if self.maps.get("libcuda") or self.maps.get("libtorch"):
            self.stop()
            fail(self.phase, f"the {self.what} {self.name} maps {self.maps}")
        return self


class KubeletChild(ControlPlane):
    """`python -m kubernetes_tpu_torch.cmd.hyperkube kubelet` as a child
    on the process runtime under `root_dir`, serving its API on a free
    port: up when its node is registered with a daemon endpoint whose
    /healthz answers 200, then it must map neither libcuda nor libtorch."""

    what = "kubelet"

    def __init__(self, phase, server, node, root_dir):
        self.phase = phase
        self.server = server
        self.node = node
        self.port = 0
        self.cmd = [sys.executable, "-m", "kubernetes_tpu_torch.cmd.hyperkube", "kubelet",
                    "--server", server, "--node-name", node, "--container-runtime", "process",
                    "--root-dir", root_dir, "--http-port", "0"]
        self._spawn()

    def __enter__(self):
        import urllib.request

        deadline = time.monotonic() + KUBELET_UP_S
        while True:
            if self.proc.poll() is not None:
                fail(self.phase, f"kubelet {self.node} exited with {self.proc.returncode}: "
                                 f"{self.tail()}")
            try:
                nodes = _raw_list(self.server, "/api/v1/nodes")[0]
                port = (nodes.get(self.node, {}).get("status", {}).get("daemonEndpoints", {})
                        .get("kubeletEndpoint", {}).get("port", 0))
                if port:
                    with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz",
                                                timeout=5) as resp:
                        if resp.status == 200:
                            self.port = port
                            break
            except OSError:
                pass
            if time.monotonic() > deadline:
                self.stop()
                fail(self.phase, f"kubelet {self.node} did not register in {KUBELET_UP_S} s: "
                                 f"{self.tail()}")
            time.sleep(0.1)
        self.maps = _maps_of(self.proc.pid)
        if self.maps.get("libcuda") or self.maps.get("libtorch"):
            self.stop()
            fail(self.phase, f"kubelet {self.node} maps {self.maps}")
        return self


class ProxyChild(ControlPlane):
    """`python -m kubernetes_tpu_torch.cmd.hyperkube proxy --no-real-portals`
    as a child: up when its own /healthz answers 200."""

    what = "proxy"

    def __init__(self, phase, server):
        self.phase = phase
        self.port = _free_port()
        self.url = f"http://127.0.0.1:{self.port}"
        self.cmd = [sys.executable, "-m", "kubernetes_tpu_torch.cmd.hyperkube", "proxy",
                    "--server", server, "--no-real-portals", "--healthz-port", str(self.port)]
        self._spawn()


def _ready_node(node):
    conds = [c for c in (node.get("status") or {}).get("conditions") or []
             if c.get("type") == "Ready"]
    return conds[0] if conds else {}


def _pod_running(pod):
    st = pod.get("status") or {}
    cs = st.get("containerStatuses") or []
    return bool(st.get("phase") == "Running" and st.get("podIP") and cs
                and all(c.get("ready") for c in cs))


def _abnormal_pods(url):
    """{reason: pods} for the pods with an event outside the normal start
    sequence (density.go's abnormal events)."""
    events = _raw_list(url, "/api/v1/namespaces/default/events")[0]
    out = {}
    for e in events.values():
        if e.get("reason") in ABNORMAL_REASONS:
            out.setdefault(e["reason"], set()).add(e["involvedObject"]["name"])
    return out


def _stamped_startup(pods):
    """From the stored stamps (whole seconds, UTC): each pod's creation
    to its kubelet's first status write (`status.startTime`) and to its
    Ready condition's last transition. They do not depend on when this
    process's watch read the events."""
    import calendar

    def sec(stamp):
        return calendar.timegm(time.strptime(stamp, "%Y-%m-%dT%H:%M:%SZ"))

    out = {"create_to_kubelet_start": [], "create_to_ready": []}
    for p in pods.values():
        st = p.get("status") or {}
        created = sec(p["metadata"]["creationTimestamp"])
        if st.get("startTime"):
            out["create_to_kubelet_start"].append(sec(st["startTime"]) - created)
        ready = [c for c in st.get("conditions") or [] if c.get("type") == "Ready"
                 and c.get("status") == "True" and c.get("lastTransitionTime")]
        if ready:
            out["create_to_ready"].append(sec(ready[0]["lastTransitionTime"]) - created)
    return out


def run_kubelet_density(torch, device, smi):
    """Leg kubelet_density: the reference's density e2e (test/e2e/
    density.go: 30 pods a node; the 100-node, 3,000-pod pod-startup SLO)
    on the port alone. The port's apiserver child, `hyperkube
    controller-manager` as a child at its command's defaults, a
    hollow-node child running DENSITY_NODES port kubelets on
    `FakeRuntime` at JAX's defaults (cpu 4, memory 8Gi, max-pods 110,
    heartbeat 5 s, sync 3 s), the incremental daemon started on the
    card, then one RC of DENSITY_PODS replicas (cpu 100m, memory 16Mi),
    later scaled to DENSITY_SCALED. Enforced: every node registered by
    its kubelet and Ready, with a heartbeat written after its
    registration; every pod Running with a pod IP and every container
    ready; no node over capacity; pods with abnormal events at most 1%;
    after the scale-down the removed pods gone from the apiserver and
    from their kubelets' runtimes, the rest Running on their nodes;
    neither the hollow-node nor the controller-manager child maps
    libcuda or libtorch. Reports the kubelets' start to all nodes
    registered, create to bound and create to Running (p50, p99, max;
    the 5 s SLO reported, not enforced; a pod's create is its first
    sight on this process's watch) and bound to Running, first create to
    last Running,
    Running pods a second, scale-down to the last pod gone, the CPU
    seconds of the three children and K1's launches."""
    from kubernetes_tpu_torch.client.rest import Client, HTTPTransport
    from kubernetes_tpu_torch.scheduler.daemon import SchedulerConfig

    phase = "kubelet_density"
    t_leg = time.perf_counter()
    names = [f"node-{i}" for i in range(DENSITY_NODES)]
    with ControlPlane(phase) as cp:
        client = Client(HTTPTransport(cp.url))
        with ControllerManagerChild(phase, cp.url) as cm:
            t_spawn = time.monotonic()
            with HollowNodes(phase, cp.url, names) as hollow:
                _wait(phase, f"{DENSITY_NODES} nodes registered",
                      lambda: len(_raw_list(cp.url, "/api/v1/nodes")[0]) == DENSITY_NODES,
                      timeout=KUBELET_UP_S)
                registered_s = time.monotonic() - t_spawn
                registered_stamp = time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime())
                cfg = SchedulerConfig(Client(HTTPTransport(cp.url))).start()
                daemon = watch = None
                try:
                    daemon = _started_daemon(phase, torch, device, cfg, 0)
                    _k1_set()
                    daemon.start()
                    watch = _CreateBindWatch(cp.url)
                    cpu0 = {"kubelets": hollow.cpu_seconds(), "controller_manager":
                            cm.cpu_seconds(), "apiserver": cp.cpu_seconds(),
                            "smoke": time.process_time()}
                    t_first = time.monotonic()
                    client.create("replicationcontrollers",
                                  _rc_wire("density", DENSITY_PODS, DENSITY_CPU, DENSITY_MEM),
                                  namespace="default")
                    _wait(phase, f"{DENSITY_PODS} pods Running",
                          lambda: len(watch.running) >= DENSITY_PODS, timeout=DENSITY_WAIT_S)
                    seen = dict(watch.seen)
                    running = dict(watch.running)
                    relists = hollow.relists()
                    cpu_s = {"kubelets": hollow.cpu_seconds(), "controller_manager":
                             cm.cpu_seconds(), "apiserver": cp.cpu_seconds(),
                             "smoke": time.process_time()}
                    cpu_s = {k: v - cpu0[k] for k, v in cpu_s.items()}
                    pods = _pods_wire(cp.url)
                    nodes = _raw_list(cp.url, "/api/v1/nodes")[0]
                    not_running = [n for n, p in pods.items() if not _pod_running(p)]
                    over = _over_capacity(pods, nodes)
                    bad_nodes = [n for n, o in nodes.items()
                                 if _ready_node(o).get("status") != "True"
                                 or _ready_node(o).get("reason") != "KubeletReady"]
                    if len(pods) != DENSITY_PODS or not_running or over or bad_nodes:
                        fail(phase, f"{len(pods)} pods of {DENSITY_PODS}, {len(not_running)} "
                                    f"not Running and ready ({not_running[:3]}), nodes over "
                                    f"capacity {over[:3]}, nodes not Ready by their kubelet "
                                    f"{bad_nodes[:3]}")
                    stamped = _stamped_startup(pods)
                    abnormal = _abnormal_pods(cp.url)
                    n_abnormal = len(set().union(*abnormal.values())) if abnormal else 0
                    if n_abnormal > DENSITY_PODS // 100:
                        fail(phase, f"{n_abnormal} pods with abnormal events: "
                                    f"{ {r: len(p) for r, p in abnormal.items()} }")
                    # The scale-down: the removed pods leave the apiserver
                    # and their kubelets' runtimes.
                    t0 = time.monotonic()
                    client.patch("replicationcontrollers", "density",
                                 {"spec": {"replicas": DENSITY_SCALED}}, namespace="default")
                    _wait(phase, f"{DENSITY_SCALED} pods left",
                          lambda: len(_pods_wire(cp.url)) == DENSITY_SCALED, timeout=60)
                    gone_api_s = time.monotonic() - t0
                    left = _pods_wire(cp.url)
                    want = {}
                    for p in left.values():
                        want.setdefault(p["spec"]["nodeName"], []).append(p["metadata"]["uid"])
                    want = {n: sorted(want.get(n, [])) for n in names}

                    def runtimes_follow():
                        return hollow.pods() == want

                    _wait(phase, "the kubelets' runtimes at the scaled pods", runtimes_follow,
                          timeout=60)
                    scale_down_s = time.monotonic() - t0
                    moved = [n for n, p in left.items()
                             if n not in pods or pods[n]["spec"]["nodeName"] != p["spec"][
                                 "nodeName"] or not _pod_running(p)]
                    def stale():
                        return [n for n, o in _raw_list(cp.url, "/api/v1/nodes")[0].items()
                                if not _ready_node(o).get("lastHeartbeatTime", "")
                                > registered_stamp]

                    # A kubelet beats every 5 s after a random phase: two
                    # periods and the stamps' whole second.
                    t_beat = time.monotonic()
                    while stale() and time.monotonic() - t_beat < 2 * 5.0 + 1.0:
                        time.sleep(0.5)
                    stale = stale()
                    launches = _k1_count()
                    errors = daemon.device_errors
                    maps = {"kubelets": _maps_of(hollow.proc.pid),
                            "controller_manager": _maps_of(cm.proc.pid)}
                finally:
                    if watch is not None:
                        watch.close()
                    if daemon is not None:
                        daemon.stop()
                    cfg.stop()
                hollow_start_s = hollow.start_s
            cm_cmd = cm.cmd
        command = cp.cmd
    loaded = [k for k, m in maps.items() if m.get("libcuda") or m.get("libtorch")]
    if moved or stale or launches < 1 or errors or loaded:
        fail(phase, f"after the scale-down {len(moved)} kept pods moved or not Running "
                    f"({moved[:3]}); nodes with no heartbeat since registration {stale[:3]}; "
                    f"{launches} K1 launches, {errors} errors; children mapping CUDA or torch "
                    f"{loaded}: {maps}")
    created = {k: v[0] for k, v in seen.items()}
    to_bind = [b - created[k] for k, (a, b) in seen.items() if b is not None]
    to_run = [t - created[k] for k, t in running.items() if k in created]
    bound_to_run = [t - seen[k][1] for k, t in running.items() if k in seen and seen[k][1]]
    last_running = max(running.values())

    def pct(xs):
        return {"p50": _percentile(xs, 50), "p99": _percentile(xs, 99), "max": max(xs),
                "n": len(xs)}

    startup = pct(to_run)
    return {
        "card": smi, "apiserver": " ".join(command), "controller_manager": " ".join(cm_cmd[2:]),
        "nodes": DENSITY_NODES, "pods": DENSITY_PODS, "cpu": DENSITY_CPU, "memory": DENSITY_MEM,
        "kubelet": {"runtime": "fake", "cpu": "4", "memory": "8Gi", "max_pods": 110,
                    "heartbeat_s": 5.0, "sync_s": 3.0},
        "kubelets_started_s": hollow_start_s,
        "kubelet_start_to_all_registered_s": registered_s,
        "create_to_bound_s": pct(to_bind), "create_to_running_s": startup,
        "bound_to_running_s": pct(bound_to_run),
        "stamped_s": {k: pct(v) for k, v in stamped.items()},
        "slo": {"p99_create_to_running_s": DENSITY_SLO_S,
                "met": startup["p99"] < DENSITY_SLO_S, "enforced": False},
        "first_create_to_last_running_s": last_running - t_first,
        "running_per_s": DENSITY_PODS / (last_running - t_first),
        "kubelet_informer_relists": relists,
        "abnormal_pods": {r: sorted(p)[:5] for r, p in abnormal.items()},
        "abnormal_count": n_abnormal,
        "scaled_to": DENSITY_SCALED, "scale_down_to_gone_from_apiserver_s": gone_api_s,
        "scale_down_to_gone_from_runtimes_s": scale_down_s,
        "cpu_s": cpu_s, "k1_launches": launches, "children_maps": maps,
        "leg_s": time.perf_counter() - t_leg,
        "timed": "host clock of this process; a pod's create is its first sight on this "
                 "process's watch of the default namespace, its bind the first event with a "
                 "nodeName, its Running the first with phase Running; stamped_s from the "
                 "stored stamps (whole seconds), whatever this process's watch saw",
    }


def _echo_pod_wire(name, port):
    return {"kind": "Pod", "metadata": {"name": name, "namespace": "default",
                                        "labels": {"app": "echo"}},
            "spec": {"volumes": [{"name": "secret", "secret": {"secretName": "echo-secret"}}],
                     "containers": [{
                         "name": "echo", "image": "echo",
                         "command": [sys.executable, "-c", ECHO_LAUNCHER], "args": [str(port)],
                         "ports": [{"name": "http", "containerPort": port}],
                         "readinessProbe": {"httpGet": {"path": "/", "port": port}}}]}}


def _http_get(addr, path="/"):
    import http.client

    conn = http.client.HTTPConnection(*addr, timeout=10)
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        return resp.status, resp.read().decode(errors="replace")
    finally:
        conn.close()


def _alive(pid):
    """A live process that is not a zombie."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] != "Z"
    except OSError:
        return False


def _kill_recorded_pods(root):
    """SIGKILL every process the process runtimes under `root` recorded
    (each pod's anchor and containers lead their own process groups):
    a leg that stops early leaves no pod behind its stopped kubelets."""
    import glob
    import signal

    for record in glob.glob(os.path.join(root, "*", "pods", "*", "*.json")):
        try:
            with open(record) as f:
                pid = int(json.load(f).get("pid", 0))
        except (OSError, ValueError):
            continue
        if pid > 0 and _alive(pid):
            try:
                os.killpg(pid, signal.SIGKILL)
            except OSError:
                pass


def run_kubelet_service(torch, device, smi):
    """Leg kubelet_service: real processes, volumes, probes, endpoints and
    the proxy. The port's apiserver and controller-manager children, two
    `hyperkube kubelet --container-runtime process` children (n1, n2),
    the incremental daemon started on the card, a secret `echo-secret`,
    SERVICE_PODS pods `echo-0..2` (label app=echo), each running
    ECHO_LAUNCHER on a free port named `http` with an HTTP readiness
    probe and the secret mounted, and a service `echo` (port 80,
    targetPort http). Enforced: every pod Running and ready, anchored by
    the port-built pause under kubernetes_tpu_torch/build/; Endpoints
    `echo` lists the three; through a `ProxyServer` (no real portals) in
    this process SERVICE_REQUESTS requests are answered equally by each
    pod with the secret's value; one request through the apiserver's
    service proxy is answered; `pods/echo-1/log`, relayed by the
    apiserver to the kubelet, holds the container's output; a `hyperkube
    proxy --no-real-portals` child answers /healthz; echo-0 deleted, its
    processes are gone, Endpoints drops it and SERVICE_AFTER requests
    reach only the other two, equally; no child maps libcuda or libtorch;
    the loopback device's addresses and the mount table are as before.
    Reports create to Running and to ready in Endpoints, delete to
    dropped from Endpoints and to the processes gone, and a request's
    latency through the portal (p50, p99)."""
    import base64
    import secrets
    import tempfile

    from kubernetes_tpu_torch.client.rest import Client, HTTPTransport
    from kubernetes_tpu_torch.proxy.config import ProxyServer
    from kubernetes_tpu_torch.scheduler.daemon import SchedulerConfig

    phase = "kubelet_service"
    t_leg = time.perf_counter()
    before = _loopback_and_mounts()
    value = secrets.token_hex(8)
    ports = [_free_port() for _ in range(SERVICE_PODS)]
    pods = [f"echo-{i}" for i in range(SERVICE_PODS)]
    root = tempfile.mkdtemp(prefix="kubelet-service-")
    proxy = None
    procs = {}
    try:
        with ControlPlane(phase) as cp, ControllerManagerChild(phase, cp.url) as cm, \
                KubeletChild(phase, cp.url, "n1", os.path.join(root, "n1")) as k1, \
                KubeletChild(phase, cp.url, "n2", os.path.join(root, "n2")) as k2, \
                ProxyChild(phase, cp.url) as proxy_child:
            kubelets = {"n1": k1, "n2": k2}
            client = Client(HTTPTransport(cp.url))
            client.create("secrets", {"kind": "Secret", "metadata": {"name": "echo-secret"},
                                      "data": {"value": base64.b64encode(value.encode())
                                               .decode()}}, namespace="default")
            client.create("services", {"kind": "Service",
                                       "metadata": {"name": "echo", "namespace": "default"},
                                       "spec": {"selector": {"app": "echo"},
                                                "ports": [{"port": 80, "targetPort": "http"}]}},
                          namespace="default")
            cfg = SchedulerConfig(Client(HTTPTransport(cp.url))).start()
            daemon = None
            try:
                daemon = _started_daemon(phase, torch, device, cfg, 0)
                _k1_set()
                daemon.start()
                t_create = time.monotonic()
                for name, port in zip(pods, ports):
                    client.create("pods", _echo_pod_wire(name, port), namespace="default")

                def endpoint_ports():
                    ep = _raw_list(cp.url, "/api/v1/namespaces/default/endpoints")[0].get(
                        "echo", {})
                    return sorted(p["port"] for s in ep.get("subsets") or []
                                  for p in s.get("ports") or [] for _ in s.get("addresses") or [])

                _wait(phase, "the echo pods Running and ready", lambda: all(
                    _pod_running(p) for p in (lambda w: [w.get(n, {}) for n in pods])(
                        _pods_wire(cp.url))), timeout=SERVICE_WAIT_S)
                running_s = time.monotonic() - t_create
                _wait(phase, "Endpoints echo listing the three",
                      lambda: endpoint_ports() == sorted(ports), timeout=SERVICE_WAIT_S)
                endpoints_s = time.monotonic() - t_create
                wire = _pods_wire(cp.url)
                # Each pod's anchor is the port-built pause, its container a process.
                procs = {}
                pause_dir = os.path.join(REPO, "kubernetes_tpu_torch", "build")
                for name in pods:
                    p = wire[name]
                    pod_dir = os.path.join(root, p["spec"]["nodeName"], "pods",
                                           p["metadata"]["uid"])
                    with open(os.path.join(pod_dir, "_pause.json")) as f:
                        anchor = json.load(f)["pid"]
                    container = int(p["status"]["containerStatuses"][0]["containerID"]
                                    .split("://")[1])
                    exe = os.readlink(f"/proc/{anchor}/exe")
                    if not (exe.startswith(pause_dir + os.sep + "pause-")
                            and exe.endswith(os.sep + "pause") and _alive(container)):
                        fail(phase, f"{name}: anchor {anchor} runs {exe}, container {container} "
                                    f"alive {_alive(container)}")
                    procs[name] = (anchor, container)
                proxy = ProxyServer(Client(HTTPTransport(cp.url)), real_portals=False).start()
                cluster_ip = _raw_list(cp.url, "/api/v1/namespaces/default/services")[0][
                    "echo"]["spec"]["clusterIP"]
                _wait(phase, "the proxy's portal and endpoints", lambda: (
                    proxy.resolve_portal(cluster_ip, 80) is not None
                    and len(proxy.lb.endpoints_for(("default", "echo", ""))) == SERVICE_PODS),
                    timeout=SERVICE_WAIT_S)

                def dropped(i, error, took):
                    """Fail the phase on a request the portal dropped, with
                    what the proxy, Endpoints and the pods showed then."""
                    state = {n: {"phase": (p.get("status") or {}).get("phase"),
                                 "ready": [c.get("ready") for c in
                                           (p.get("status") or {}).get("containerStatuses") or []],
                                 "restarts": [c.get("restartCount") for c in
                                              (p.get("status") or {}).get("containerStatuses") or []]}
                             for n, p in _pods_wire(cp.url).items()}
                    logs = {}
                    for n in state:
                        try:
                            logs[n] = _http_get(("127.0.0.1", cp.port),
                                                f"/api/v1/namespaces/default/pods/{n}/log")[1][-600:]
                        except OSError as e:
                            logs[n] = repr(e)
                    fail(phase, f"request {i} through the portal: {error!r} after {took:.3f} s; "
                                f"the proxy's endpoints {proxy.lb.endpoints_for(('default', 'echo', ''))}, "
                                f"Endpoints echo {endpoint_ports()}, pods {state}, logs {logs}")

                def requests(n):
                    out, lat = [], []
                    for i in range(n):
                        t0 = time.perf_counter()
                        try:
                            code, body = _http_get(proxy.resolve_portal(cluster_ip, 80))
                        except OSError as e:  # http.client's RemoteDisconnected among them
                            dropped(i, e, time.perf_counter() - t0)
                        lat.append(time.perf_counter() - t0)
                        out.append((code, body))
                    return out, lat

                answers, latency = requests(SERVICE_REQUESTS)
                by_pod = {}
                for code, body in answers:
                    name, _, got = body.partition(" ")
                    if code != 200 or got != value:
                        fail(phase, f"a request through the portal answered {code} {body!r}")
                    by_pod[name] = by_pod.get(name, 0) + 1
                if by_pod != {n: SERVICE_REQUESTS // SERVICE_PODS for n in pods}:
                    fail(phase, f"the portal spread {SERVICE_REQUESTS} requests as {by_pod}")
                code, body = _http_get(("127.0.0.1", cp.port),
                                       "/api/v1/namespaces/default/services/echo/proxy/")
                if code != 200 or body.partition(" ")[2] != value:
                    fail(phase, f"the apiserver's service proxy answered {code} {body!r}")
                code, log = _http_get(("127.0.0.1", cp.port),
                                      "/api/v1/namespaces/default/pods/echo-1/log")
                if code != 200 or f"serving echo-1 on {ports[1]}" not in log:
                    fail(phase, f"pods/echo-1/log answered {code} {log!r}")
                code, health = _http_get(("127.0.0.1", proxy_child.port), "/healthz")
                if code != 200:
                    fail(phase, f"the proxy child's /healthz answered {code} {health!r}")
                # Delete echo-0.
                t_delete = time.monotonic()
                client.delete("pods", "echo-0", namespace="default")
                _wait(phase, "Endpoints echo without echo-0",
                      lambda: endpoint_ports() == sorted(ports[1:]), timeout=SERVICE_WAIT_S)
                dropped_s = time.monotonic() - t_delete
                _wait(phase, "echo-0's processes gone",
                      lambda: not any(_alive(pid) for pid in procs["echo-0"]),
                      timeout=SERVICE_WAIT_S)
                gone_s = time.monotonic() - t_delete
                _wait(phase, "the proxy without echo-0", lambda: len(
                    proxy.lb.endpoints_for(("default", "echo", ""))) == SERVICE_PODS - 1,
                    timeout=SERVICE_WAIT_S)
                after, after_latency = requests(SERVICE_AFTER)
                after_by_pod = {}
                for code, body in after:
                    name, _, got = body.partition(" ")
                    if code != 200 or got != value:
                        fail(phase, f"a request after the delete answered {code} {body!r}")
                    after_by_pod[name] = after_by_pod.get(name, 0) + 1
                if after_by_pod != {n: SERVICE_AFTER // 2 for n in pods[1:]}:
                    fail(phase, f"after the delete the portal spread {after_by_pod}")
                launches = _k1_count()
                errors = daemon.device_errors
                maps = {"apiserver": _maps_of(cp.proc.pid), "controller_manager":
                        _maps_of(cm.proc.pid), "proxy": _maps_of(proxy_child.proc.pid),
                        **{f"kubelet_{n}": _maps_of(k.proc.pid) for n, k in kubelets.items()}}
                # A pod outlives its kubelet (a restarted kubelet adopts
                # it): delete the others so their kubelets end them.
                for name in pods[1:]:
                    client.delete("pods", name, namespace="default")
                _wait(phase, "every echo pod's processes gone", lambda: not any(
                    _alive(pid) for pair in procs.values() for pid in pair),
                    timeout=SERVICE_WAIT_S)
            finally:
                if proxy is not None:
                    proxy.stop()
                if daemon is not None:
                    daemon.stop()
                cfg.stop()
            commands = {"kubelet": " ".join(k1.cmd[2:]), "proxy": " ".join(proxy_child.cmd[2:])}
    finally:
        _kill_recorded_pods(root)
        shutil.rmtree(root, ignore_errors=True)
    after_state = _loopback_and_mounts()
    loaded = [k for k, m in maps.items() if m.get("libcuda") or m.get("libtorch")]
    if launches < 1 or errors or loaded or after_state != before:
        fail(phase, f"{launches} K1 launches, {errors} errors; children mapping CUDA or torch "
                    f"{loaded}; local addresses {before[0]} -> {after_state[0]}, mount table "
                    f"changed {after_state[1] != before[1]}")
    return {
        "card": smi, "commands": commands, "pods": SERVICE_PODS, "kubelets": 2,
        "runtime": "process", "create_to_running_s": running_s,
        "create_to_ready_in_endpoints_s": endpoints_s,
        "delete_to_dropped_from_endpoints_s": dropped_s, "delete_to_processes_gone_s": gone_s,
        "portal_request_s": {"p50": _percentile(latency + after_latency, 50),
                             "p99": _percentile(latency + after_latency, 99),
                             "n": len(latency) + len(after_latency)},
        "answers": by_pod, "answers_after_delete": after_by_pod,
        "pause": os.path.relpath(os.readlink(f"/proc/{procs['echo-1'][0]}/exe"), REPO)
        if _alive(procs["echo-1"][0]) else "exited",
        "local_addresses": before[0] if before[0] is not None else
        "unreadable: no /proc/net/fib_trie and no ip command (nor could a portal add one)",
        "mounts_unchanged": True if before[1] is not None else "unreadable: no /proc/mounts",
        "k1_launches": launches, "children_maps": maps,
        "leg_s": time.perf_counter() - t_leg,
        "timed": "host clock of this process, polling the apiserver every 50 ms",
    }


def run_controller_node_loss(torch, device, smi):
    """Leg controller_node_loss on real kubelets: NODE_LOSS_NODES port
    kubelets on `FakeRuntime` (cpu 16, memory 32Gi, heartbeat
    HEARTBEAT_S), fifteen in one hollow-node child and n0 in a child of
    its own, against the port's apiserver child; the controller-manager
    child with a grace of NODE_LOSS_GRACE_S and an eviction timeout of
    NODE_LOSS_EVICTION_S; the incremental daemon started on the card.
    One RC of NODE_LOSS_REPLICAS replicas runs across the nodes, then
    n0's child is SIGKILLed. Reports the seconds from the kill to n0's
    NotReady, to its pods' eviction, and to all replicas bound again and
    Running, none on n0, with n0's last stored lastHeartbeatTime beside
    them."""
    from kubernetes_tpu_torch.client.rest import Client, HTTPTransport
    from kubernetes_tpu_torch.scheduler.daemon import SchedulerConfig

    phase = "controller_node_loss"
    t_leg = time.perf_counter()
    kw = dict(cpu="16", memory="32Gi", heartbeat_s=HEARTBEAT_S, sync_s=HEARTBEAT_S)
    with ControlPlane(phase) as cp:
        client = Client(HTTPTransport(cp.url))
        with HollowNodes(phase, cp.url, [f"n{j}" for j in range(1, NODE_LOSS_NODES)], **kw) \
                as rest, HollowNodes(phase, cp.url, ["n0"], **kw) as n0_child:
            _wait(phase, f"{NODE_LOSS_NODES} nodes registered",
                  lambda: len(_raw_list(cp.url, "/api/v1/nodes")[0]) == NODE_LOSS_NODES,
                  timeout=KUBELET_UP_S)
            with ControllerManagerChild(phase, cp.url, NODE_LOSS_GRACE_S,
                                        NODE_LOSS_EVICTION_S) as cm:
                cfg = SchedulerConfig(Client(HTTPTransport(cp.url))).start()
                daemon = None
                try:
                    daemon = _started_daemon(phase, torch, device, cfg, 0)
                    _k1_set()
                    daemon.start()
                    client.create("replicationcontrollers",
                                  _rc_wire("web", NODE_LOSS_REPLICAS, "500m", "64Mi"),
                                  namespace="default")

                    def placement():
                        return {n: ((o.get("spec") or {}).get("nodeName"), _pod_running(o))
                                for n, o in _pods_wire(cp.url).items()}

                    _wait(phase, "the RC's replicas Running", lambda: (
                        len(p := placement()) == NODE_LOSS_REPLICAS
                        and all(r for _, r in p.values())), timeout=NODE_LOSS_WAIT_S)
                    before = placement()
                    on_n0 = sorted(n for n, (node, _) in before.items() if node == "n0")
                    if not on_n0:
                        fail(phase, f"no replica landed on n0: {before}")
                    n0_child.kill()
                    t_kill = time.monotonic()
                    kill_stamp = time.time()
                    times, reason, last_beat = {}, None, None
                    deadline = time.monotonic() + NODE_LOSS_WAIT_S
                    while len(times) < 4:
                        if time.monotonic() > deadline:
                            fail(phase, f"after n0's kill only {sorted(times)} within "
                                        f"{NODE_LOSS_WAIT_S} s")
                        now = time.monotonic()
                        if "not_ready" not in times:
                            ready = _ready_node(client.get_wire("nodes", "n0"))
                            last_beat = ready.get("lastHeartbeatTime")
                            if ready.get("status") != "True":
                                times["not_ready"] = now - t_kill
                                reason = ready.get("reason")
                        p = placement()
                        if "evicted" not in times and not any(n in p for n in on_n0):
                            times["evicted"] = now - t_kill
                        back = ("evicted" in times and len(p) == NODE_LOSS_REPLICAS
                                and all(node and node != "n0" for node, _ in p.values()))
                        if back and "rebound" not in times:
                            times["rebound"] = now - t_kill
                        if back and all(r for _, r in p.values()):
                            times["running"] = now - t_kill
                        time.sleep(0.05)
                    launches = _k1_count()
                    errors = daemon.device_errors
                    probe_end = _cuda_context_of(cm.proc.pid)
                    maps = {"kubelets": _maps_of(rest.proc.pid),
                            "controller_manager": _maps_of(cm.proc.pid)}
                finally:
                    if daemon is not None:
                        daemon.stop()
                    cfg.stop()
                cm_cmd, cm_probe = cm.cmd, cm.cuda_probe
        command = cp.cmd
    import calendar

    beat_age = (kill_stamp - calendar.timegm(time.strptime(last_beat, "%Y-%m-%dT%H:%M:%SZ"))
                if last_beat else None)
    loaded = [k for k, m in maps.items() if m.get("libcuda") or m.get("libtorch")]
    if reason != "NodeStatusUnknown" or launches < 1 or errors or probe_end[0] or loaded:
        fail(phase, f"NotReady reason {reason!r}, {launches} K1 launches, {errors} errors, the "
                    f"controller-manager's CUDA probe {probe_end[1]}, children mapping CUDA or "
                    f"torch {loaded}")
    return {
        "card": smi, "apiserver": " ".join(command), "controller_manager": " ".join(cm_cmd[2:]),
        "nodes": NODE_LOSS_NODES, "kubelets": "port, FakeRuntime, 15 in one child, n0 alone",
        "replicas": NODE_LOSS_REPLICAS, "evicted_pods": len(on_n0),
        "grace_s": NODE_LOSS_GRACE_S, "eviction_timeout_s": NODE_LOSS_EVICTION_S,
        "heartbeat_s": HEARTBEAT_S,
        "n0_last_heartbeat": last_beat, "n0_last_heartbeat_age_at_kill_s": beat_age,
        "kill_to_not_ready_s": times["not_ready"], "kill_to_evicted_s": times["evicted"],
        "kill_to_all_rebound_s": times["rebound"], "kill_to_all_running_s": times["running"],
        "none_on_n0": True, "k1_launches": launches,
        "controller_manager_cuda_context": {"start": cm_probe, "end": probe_end[1]},
        "children_maps": maps, "leg_s": time.perf_counter() - t_leg,
        "timed": "host clock of this process, polling the apiserver every 50 ms from the "
                 "monotonic second n0's kubelet child was SIGKILLed; n0's last heartbeat is "
                 "the stamp its kubelet last stored (whole seconds, UTC)",
    }


# ---------------------------------------------------------------------------
# The cloud controllers and local-up-cluster (legs of phase 5o)
# ---------------------------------------------------------------------------


CLOUD_WAIT_S = 60.0  # each cloud state after its cause (the child's start: imports, inventory)
LOCAL_UP_NODES = 4
LOCAL_UP_REPLICAS = 200
LOCAL_UP_WAIT_S = 120.0  # the RC's pods to Running, and the child's stop


def _card_names():
    """The cards' names as `nvidia-smi` lists them, one a card."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    return [line.strip() for line in out.stdout.splitlines() if line.strip()]


def _sample(text, key):
    """The value of the Prometheus sample `key` (name and labels) in
    `text`, 0 when absent."""
    for line in text.splitlines():
        if line.startswith(key + " "):
            return float(line.split()[-1])
    return 0.0


class CloudManagerChild(ControllerManagerChild):
    """`hyperkube controller-manager --cloud-provider gpu` as a child: the
    provider reads the card inventory through torch.cuda, so this is the
    one controller-manager child that may hold a CUDA context."""

    what = "cloud controller-manager"
    host_only = False

    def __init__(self, phase, server):
        self.phase = phase
        self.port = _free_port()
        self.url = f"http://127.0.0.1:{self.port}"
        self.cmd = [sys.executable, "-m", "kubernetes_tpu_torch.cmd.hyperkube",
                    "controller-manager", "--server", server, "--healthz-port", str(self.port),
                    "--cloud-provider", "gpu"]
        self._spawn()

    def metrics(self):
        import urllib.request

        with urllib.request.urlopen(self.url + "/metrics", timeout=30) as resp:
            return resp.read().decode()


def run_cloud_controllers(torch, device, smi):
    """Leg cloud_controllers: `hyperkube controller-manager --cloud-provider
    gpu` against the port's apiserver child. The card's host registers as
    node gpu-host-0 labelled with the cards' name and count as nvidia-smi
    lists them; a LoadBalancer service gets its ingress; a podCIDR set on
    the node is synced by the route controller; the service turned
    ClusterIP loses its ingress and, deleted, is synced away; no sync
    errs; SIGTERM stops the child with 0."""
    from kubernetes_tpu_torch.client.rest import Client, HTTPTransport
    from kubernetes_tpu_torch.cloudprovider import gpu
    from kubernetes_tpu_torch.controllers import cloudnodes

    phase = "cloud_controllers"
    t_leg = time.perf_counter()
    cards = _card_names()
    with ControlPlane(phase) as cp:
        client = Client(HTTPTransport(cp.url))
        t0 = time.monotonic()
        cm = CloudManagerChild(phase, cp.url)
        try:
            cm.__enter__()
            up_s = time.monotonic() - t0
            registered_s = up_s + _wait(phase, "gpu-host-0 registered", lambda: "gpu-host-0" in
                                        _raw_list(cp.url, "/api/v1/nodes")[0],
                                        CLOUD_WAIT_S, interval=0.02)
            labels = client.get_wire("nodes", "gpu-host-0")["metadata"].get("labels") or {}
            want = {gpu.LABEL_PLATFORM: "gpu", gpu.LABEL_CHIP: cards[0].replace(" ", "-"),
                    gpu.LABEL_CHIPS: str(len(cards)), gpu.LABEL_HOST: "0",
                    cloudnodes.LABEL_MANAGED: "cloud"}
            wrong = {k: (labels.get(k), v) for k, v in want.items() if labels.get(k) != v}
            if wrong:
                fail(phase, f"gpu-host-0's labels against nvidia-smi's {cards}: {wrong}")

            def ingress():
                got = client.get_wire("services", "edge", namespace="default")
                return ((got.get("status") or {}).get("loadBalancer") or {}).get("ingress")

            # A LoadBalancer service: its ingress is published.
            client.create("services", {"kind": "Service", "metadata": {"name": "edge"},
                                       "spec": {"type": "LoadBalancer",
                                                "selector": {"app": "edge"},
                                                "ports": [{"port": 80}]}}, namespace="default")
            ingress_s = _wait(phase, "the service's ingress", ingress, CLOUD_WAIT_S,
                              interval=0.02)
            published = ingress()
            # A podCIDR on the node: the route controller syncs it.
            key = 'route_syncs_total{action="ok"}'
            before = _sample(cm.metrics(), key)
            node = client.get_wire("nodes", "gpu-host-0")
            node.setdefault("spec", {})["podCIDR"] = "10.244.0.0/24"
            client.update("nodes", node)
            route_s = _wait(phase, "a route sync after the podCIDR",
                            lambda: _sample(cm.metrics(), key) > before, CLOUD_WAIT_S,
                            interval=0.02)
            after = client.get_wire("nodes", "gpu-host-0")
            if (after.get("spec") or {}).get("podCIDR") != "10.244.0.0/24" or (
                    after["metadata"].get("labels") != labels):
                fail(phase, f"gpu-host-0 lost its podCIDR or labels: {after}")
            # Turned ClusterIP: the ingress goes; deleted: synced away.
            svc = client.get_wire("services", "edge", namespace="default")
            svc["spec"]["type"] = "ClusterIP"
            client.update("services", svc, namespace="default")
            cleared_s = _wait(phase, "the ingress cleared", lambda: not ingress(), CLOUD_WAIT_S,
                              interval=0.02)
            lb_key = 'service_lb_syncs_total{action="ok"}'
            before = _sample(cm.metrics(), lb_key)
            client.delete("services", "edge", namespace="default")
            deleted_s = _wait(phase, "a balancer sync after the delete",
                              lambda: _sample(cm.metrics(), lb_key) > before, CLOUD_WAIT_S,
                              interval=0.02)
            text = cm.metrics()
            errors = {k: _sample(text, f'{k}{{action="error"}}')
                      for k in ("cloud_node_syncs_total", "service_lb_syncs_total",
                                "route_syncs_total")}
            if any(errors.values()):
                fail(phase, f"cloud controller sync errors: {errors}")
            registers = _sample(text, 'cloud_node_syncs_total{action="register"}')
            if registers != 1:
                fail(phase, f"cloud_node_syncs_total{{action=\"register\"}} is {registers}, not 1")
            probe = cm.cuda_probe
        finally:
            cm.stop()
        if cm.proc.returncode != 0:
            fail(phase, f"the controller-manager exited with {cm.proc.returncode} on SIGTERM: "
                        f"{cm.tail()}")
    return {
        "card": smi, "cards": cards, "labels": {k: labels[k] for k in sorted(want)},
        "instance_type": labels.get(cloudnodes.LABEL_INSTANCE_TYPE),
        "start_to_healthz_s": up_s, "start_to_registered_s": registered_s,
        "create_to_ingress_s": ingress_s, "ingress": published,
        "pod_cidr_to_route_sync_s": route_s, "type_change_to_ingress_cleared_s": cleared_s,
        "delete_to_balancer_sync_s": deleted_s, "sync_errors": errors,
        "controller_manager_cuda_context": probe, "exit_code": cm.proc.returncode,
        "leg_s": time.perf_counter() - t_leg,
        "timed": "host clock of this process, polling the apiserver and the child's /metrics "
                 "every 20 ms from the child's spawn or each request's answer",
    }


def _dns_query(port, name, txid=0x4B54):
    """The A answer for `name` from the DNS server on 127.0.0.1:`port`,
    None for no answer."""
    import socket
    import struct

    q = struct.pack(">HHHHHH", txid, 0x0100, 1, 0, 0, 0)
    q += b"".join(bytes([len(p)]) + p.encode() for p in name.strip(".").split("."))
    q += b"\x00" + struct.pack(">HH", 1, 1)
    s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    s.settimeout(5.0)
    try:
        s.sendto(q, ("127.0.0.1", port))
        data = s.recvfrom(512)[0]
    finally:
        s.close()
    if data[:2] != q[:2] or not struct.unpack(">H", data[6:8])[0]:
        return None
    return socket.inet_ntoa(data[-4:])


def _group_members(pgid):
    """Live pids whose process group is `pgid` (/proc/<pid>/stat)."""
    out = []
    for name in os.listdir("/proc"):
        if not name.isdigit():
            continue
        try:
            with open(f"/proc/{name}/stat") as f:
                fields = f.read().rsplit(")", 1)[1].split()
        except OSError:
            continue
        if int(fields[2]) == pgid and fields[0] != "Z":
            out.append(int(name))
    return out


class LocalUpChild(_Scheduler):
    """`hyperkube local-up-cluster --batch-scheduler --kubelet-http
    --cluster-dns --no-kube-proxy --port 0` (or the given `flags`) as a
    child in its own session, its output in a temporary file: up when
    it has printed its apiserver's address (then `url`) and, with
    --cluster-dns, the DNS addon's port."""

    def __init__(self, phase, device, flags=None):
        import tempfile

        self.phase = phase
        flags = flags or ["--batch-scheduler", "--nodes", str(LOCAL_UP_NODES), "--kubelet-http",
                          "--cluster-dns", "--no-kube-proxy", "--port", "0"]
        self.dns = "--cluster-dns" in flags
        self.cmd = [sys.executable, "-m", "kubernetes_tpu_torch.cmd.hyperkube", "local-up-cluster",
                    *flags]
        if device.type != "cuda":  # a dry run on the CPU
            self.cmd += ["--device", "cpu"]
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(p for p in (REPO, env.get("PYTHONPATH")) if p)
        self._log = tempfile.TemporaryFile()
        self.t0 = time.monotonic()
        self.proc = subprocess.Popen(self.cmd, cwd=REPO, env=env, stdin=subprocess.DEVNULL,
                                     stdout=self._log, stderr=subprocess.STDOUT,
                                     start_new_session=True)

    def wait_up(self):
        """(the DNS addon's port or None, seconds from the spawn)."""
        import re

        while True:
            out = self.tail(1 << 20)
            url = re.search(r"cluster up: apiserver at (\S+)", out)
            dns = re.search(r"DNS serves on 127\.0\.0\.1:(\d+) only", out)
            if url and (dns or not self.dns):
                self.url = url.group(1)
                return int(dns.group(1)) if dns else None, time.monotonic() - self.t0
            if self.proc.poll() is not None or time.monotonic() - self.t0 > DEBUG_UP_S:
                self.kill()
                fail(self.phase, f"local-up-cluster did not come up in {DEBUG_UP_S} s "
                                 f"(exit {self.proc.returncode}): {self.tail()}")
            time.sleep(0.05)


def run_local_up(torch, device, smi):
    """Leg local_up: `hyperkube local-up-cluster` as a child on the card
    (the batch scheduler on it, LOCAL_UP_NODES kubelets over HTTP, the DNS
    addon on its own port, no kube-proxy). An RC of LOCAL_UP_REPLICAS
    reaches Running on its kubelets through K1 in the child (its
    /debug/kernels calls past the prewarm's), the DNS addon resolves the
    RC's service, and SIGINT stops the child with 0 and no process of its
    group left."""
    import signal

    from kubernetes_tpu_torch.client.rest import Client, HTTPTransport

    phase = "local_up"
    t_leg = time.perf_counter()
    child = LocalUpChild(phase, device)
    watch = None
    try:
        dns_port, up_s = child.wait_up()
        settled = _settled_k1_calls(child)  # the session's prewarm launches

        def ready_nodes():
            nodes = _raw_list(child.url, "/api/v1/nodes")[0]
            return sorted(n for n, o in nodes.items() if _ready_node(o).get("status") == "True")

        _wait(phase, f"{LOCAL_UP_NODES} nodes Ready",
              lambda: len(ready_nodes()) == LOCAL_UP_NODES, LOCAL_UP_WAIT_S)
        ready = ready_nodes()
        client = Client(HTTPTransport(child.url))
        watch = _CreateBindWatch(child.url)
        client.create("services", {"kind": "Service", "metadata": {"name": "web"},
                                   "spec": {"selector": {"app": "web"}, "ports": [{"port": 80}]}},
                      namespace="default")
        client.create("replicationcontrollers", _rc_wire("web", LOCAL_UP_REPLICAS, "10m"),
                      namespace="default")
        all_running_s = _wait(phase, f"{LOCAL_UP_REPLICAS} pods Running", lambda: sum(
            _pod_running(p) for p in _pods_wire(child.url, "app=web").values())
            == LOCAL_UP_REPLICAS, LOCAL_UP_WAIT_S, interval=0.02)
        k1 = _k1_calls(child.get_json("/debug/kernels")) - settled
        if k1 <= 0:
            fail(phase, f"K1 was not launched for the RC's pods (calls {settled} before)")
        pods = _pods_wire(child.url, "app=web")
        on = sorted({p["spec"]["nodeName"] for p in pods.values()})

        def watched():
            """(name, uid) of the RC's pods this watch has seen reach Running."""
            return [k for k in list(watch.running) if k[0] in pods and k in watch.seen]

        # The LIST can show the last pods Running before this process's
        # watch thread has read their events.
        _wait(phase, f"the watch to see the {LOCAL_UP_REPLICAS} pods Running",
              lambda: len(watched()) >= LOCAL_UP_REPLICAS, LOCAL_UP_WAIT_S)
        lat = sorted(watch.running[k] - watch.seen[k][0] for k in watched())
        if len(lat) != LOCAL_UP_REPLICAS:
            fail(phase, f"the watch saw {len(lat)} of {LOCAL_UP_REPLICAS} pods reach Running")
        ip = client.get_wire("services", "web", namespace="default")["spec"]["clusterIP"]
        answers = {name: _dns_query(dns_port, name) for name in (
            "web.default.svc.cluster.local", "web.default", "nope.default.svc.cluster.local")}
        if answers != {"web.default.svc.cluster.local": ip, "web.default": ip,
                       "nope.default.svc.cluster.local": None}:
            fail(phase, f"DNS answers {answers}, the service's clusterIP {ip}")
        probe = _cuda_context_of(child.proc.pid)[1]
        watch.close()
        watch = None
        t_stop = time.monotonic()
        child.proc.send_signal(signal.SIGINT)
        try:
            rc = child.proc.wait(timeout=LOCAL_UP_WAIT_S)
        except subprocess.TimeoutExpired:
            fail(phase, f"SIGINT did not stop the child in {LOCAL_UP_WAIT_S} s: {child.tail()}")
        stop_s = time.monotonic() - t_stop
        left = _group_members(child.proc.pid)
        if rc != 0 or left or "cluster stopped" not in child.tail():
            fail(phase, f"SIGINT: exit {rc}, processes left {left}: {child.tail()}")
    finally:
        if watch is not None:
            watch.close()
        child.kill()
    return {
        "card": smi, "nodes": ready, "pods_on": on, "replicas": LOCAL_UP_REPLICAS,
        "start_to_up_s": up_s, "prewarm_k1_launches": settled, "k1_launches": k1,
        "create_to_running_p50_s": _pct(lat, 0.5), "create_to_running_p99_s": _pct(lat, 0.99),
        "create_to_running_max_s": lat[-1], "first_create_to_all_running_s": all_running_s,
        "running_pods_per_s": LOCAL_UP_REPLICAS / all_running_s, "dns": answers,
        "dns_port": dns_port, "sigint_to_exit_s": stop_s, "exit_code": rc,
        "child_cuda_context": probe, "leg_s": time.perf_counter() - t_leg,
        "timed": "host clock of this process: create = the pod's first sight on this "
                 "process's watch, Running = its first event with phase Running; the child's "
                 "K1 calls read from its /debug/kernels once its prewarm's settled and after "
                 "all Running",
    }


# ---------------------------------------------------------------------------
# The port's CLI against the port's local-up-cluster (a leg of phase 5o)
# ---------------------------------------------------------------------------


KTCTL_NODES = 2
KTCTL_REPLICAS = 3
KTCTL_SCALED = 4
KTCTL_POLL_S = 0.2  # between two `get pods` of a wait, and the rolling update's poll
KTCTL_WAIT_S = 60.0  # each wait of the leg for pods, counts or a port
KTCTL_CMD_S = 120.0  # one CLI process, the rolling update included

#: The program each pod of the leg's RC runs (`sys.executable -c
#: SLEEPER_LAUNCHER`): one line with its pod's name (the pod's log), then
#: it sleeps until its kubelet stops it.
SLEEPER_LAUNCHER = r"""
import os
import time

print(f"hello from {os.environ['KUBERNETES_POD_NAME']}", flush=True)
while True:
    time.sleep(3600)
"""

#: The leg's port-forward target (`sys.executable -c HTTP_LAUNCHER port`):
#: an HTTP server on 127.0.0.1:port answering every GET with its pod's
#: name, like ECHO_LAUNCHER without the secret.
HTTP_LAUNCHER = r"""
import http.server
import os
import sys

port = int(sys.argv[1])
pod = os.environ["KUBERNETES_POD_NAME"]


class Name(http.server.BaseHTTPRequestHandler):
    def log_message(self, *args):
        pass

    def do_GET(self):
        body = pod.encode()
        self.send_response(200)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)


http.server.ThreadingHTTPServer(("127.0.0.1", port), Name).serve_forever()
"""


class KtctlRunner:
    """The port's CLI as fresh interpreters, `python -m
    kubernetes_tpu_torch.cli ARGV`, the way a user runs it: its kubeconfig
    in `KTCONFIG` (no `--server` once the config is written), each call's
    wall (the interpreter's start included) kept under its command. A
    call that exits with another code than `expect` fails the phase."""

    def __init__(self, phase, config):
        self.phase = phase
        self.env = dict(os.environ, KTCONFIG=config)
        self.env["PYTHONPATH"] = os.pathsep.join(
            p for p in (REPO, os.environ.get("PYTHONPATH")) if p)
        self.walls = {}

    def argv(self, *args):
        return [sys.executable, "-m", "kubernetes_tpu_torch.cli", *args]

    def __call__(self, *args, expect=0):
        t0 = time.monotonic()
        try:
            proc = subprocess.run(self.argv(*args), cwd=REPO, env=self.env, capture_output=True,
                                  text=True, timeout=KTCTL_CMD_S)
        except subprocess.TimeoutExpired:
            fail(self.phase, f"ktctl {' '.join(args)} did not end in {KTCTL_CMD_S} s")
        wall = time.monotonic() - t0
        name = " ".join(args[:2]) if args[0] in ("config", "top", "profile") else args[0]
        self.walls.setdefault(name, []).append(wall)
        if proc.returncode != expect:
            fail(self.phase, f"ktctl {' '.join(args)} exited {proc.returncode} (wanted {expect}): "
                             f"{proc.stderr[-800:]} {proc.stdout[-400:]}")
        return proc.stdout

    def json(self, *args):
        return json.loads(self(*args, "-o", "json"))

    def pods(self, selector):
        """The default namespace's pods with `selector`, by name, as
        `get pods -l selector -o json` prints them."""
        out = self.json("get", "pods", "-l", selector)
        items = out["items"] if out.get("kind") == "List" else [out]
        return {p["metadata"]["name"]: p for p in items}

    def wait_running(self, selector, n):
        """Seconds until exactly `n` pods with `selector` are Running
        and ready (`get pods` polled); their wire forms."""
        t0 = time.monotonic()
        while True:
            pods = self.pods(selector)
            if len(pods) == n and all(_pod_running(p) for p in pods.values()):
                return time.monotonic() - t0, pods
            if time.monotonic() - t0 > KTCTL_WAIT_S:
                fail(self.phase, f"{n} pods {selector} not Running in {KTCTL_WAIT_S} s: "
                                 f"{ {k: (v.get('status') or {}).get('phase') for k, v in pods.items()} }")
            time.sleep(KTCTL_POLL_S)

    def k1_calls(self):
        """K1's launches in the cluster's ledger, as `profile kernels -o
        json` reads them from its /debug/kernels."""
        return _k1_calls(self.json("profile", "kernels"))

    def figures(self):
        return {name: {"calls": len(w), "p50_s": statistics.median(w), "max_s": max(w)}
                for name, w in sorted(self.walls.items())}


def _sleeper_rc(name, replicas, image="sleeper:v1"):
    return {"kind": "ReplicationController", "metadata": {"name": name},
            "spec": {"replicas": replicas, "selector": {"app": name},
                     "template": {"metadata": {"labels": {"app": name}},
                                  "spec": {"containers": [{
                                      "name": "main", "image": image,
                                      "command": [sys.executable, "-c", SLEEPER_LAUNCHER],
                                      "resources": {"limits": {"cpu": "10m",
                                                               "memory": "16Mi"}}}]}}}}


def run_ktctl(torch, device, smi):
    """Leg ktctl: the port's CLI drives the port's `hyperkube
    local-up-cluster --batch-scheduler --nodes 2 --kubelet-http
    --process-runtime --no-kube-proxy --port 0` child on the card, each
    command a fresh `python -m kubernetes_tpu_torch.cli` process that
    finds the server through its kubeconfig alone. An RC of
    KTCTL_REPLICAS pods running SLEEPER_LAUNCHER is created from JSON
    with its service and reaches Running through K1 in the child (its
    launches past the prewarm, read by `profile kernels`); `explain`
    names a pod's node, `top nodes` both nodes, `top capacity` a sample;
    `logs` and `exec` answer from a pod; a `port-forward` child tunnels
    a GET to a pod running HTTP_LAUNCHER; `scale` to KTCTL_SCALED,
    `rolling-update --image`, then `stop` leaves no pod in the apiserver
    or the kubelets' runtimes; SIGINT stops the child with 0 and no
    process of its group left."""
    import importlib.util
    import signal
    import tempfile
    import types

    phase = "ktctl"
    t_leg = time.perf_counter()
    pyyaml = importlib.util.find_spec("yaml") is not None
    child = LocalUpChild(phase, device, flags=[
        "--batch-scheduler", "--nodes", str(KTCTL_NODES), "--kubelet-http", "--process-runtime",
        "--no-kube-proxy", "--port", "0"])
    forward = None
    with tempfile.TemporaryDirectory(prefix="ktctl-leg-") as tmp:
        try:
            _, up_s = child.wait_up()
            cli = KtctlRunner(phase, os.path.join(tmp, "config"))
            # 1. the kubeconfig: every later call finds the server there.
            cli("config", "set-cluster", "local", "--server-url", child.url)
            cli("config", "set-context", "local", "--cluster", "local")
            cli("config", "use-context", "local")
            if json.loads(cli("config", "view"))["current-context"] != "local":
                fail(phase, "use-context did not set the current context")
            nodes = cli.json("get", "nodes")["items"]
            if len(nodes) != KTCTL_NODES:
                _wait(phase, f"{KTCTL_NODES} nodes", lambda: len(
                    cli.json("get", "nodes")["items"]) == KTCTL_NODES, KTCTL_WAIT_S)
            settled = _settled_k1_calls(types.SimpleNamespace(
                phase=phase, get_json=lambda path: cli.json("profile", "kernels")))
            # 2. an RC and a service from JSON, to Running through K1.
            rc_file, svc_file = os.path.join(tmp, "rc.json"), os.path.join(tmp, "svc.json")
            with open(rc_file, "w") as f:
                json.dump(_sleeper_rc("web", KTCTL_REPLICAS), f)
            with open(svc_file, "w") as f:
                json.dump({"kind": "Service", "metadata": {"name": "web"},
                           "spec": {"selector": {"app": "web"}, "ports": [{"port": 80}]}}, f)
            t0 = time.monotonic()
            if cli("create", "-f", rc_file) != "replicationcontrollers/web created\n":
                fail(phase, "create -f rc.json did not say so")
            cli("create", "-f", svc_file)
            running_s, pods = cli.wait_running("app=web", KTCTL_REPLICAS)
            create_to_running_s = time.monotonic() - t0
            k1 = cli.k1_calls() - settled
            if k1 <= 0:
                fail(phase, f"K1 was not launched for the RC's pods (calls {settled} before)")
            # 3. the scheduler's record, the nodes and the capacity plane.
            first = sorted(pods)[0]
            decision = cli.json("explain", "pod", first)["decisions"][0]
            if decision.get("node") != pods[first]["spec"]["nodeName"]:
                fail(phase, f"explain names {decision.get('node')}, the pod is on "
                            f"{pods[first]['spec']['nodeName']}")
            top = cli("top", "nodes")
            node_names = sorted(n["metadata"]["name"] for n in nodes)
            if not all(n in top for n in node_names):
                fail(phase, f"top nodes does not list {node_names}: {top}")
            if "fragmentation:" not in cli("top", "capacity"):
                fail(phase, "top capacity printed no sample")
            # 4. logs, exec, and a port-forward to an HTTP pod.
            logs = cli("logs", first)
            if logs != f"hello from {first}\n":
                fail(phase, f"logs {first}: {logs!r}")
            said = cli("exec", first, "--", "printenv", "KUBERNETES_POD_NAME")
            if said != f"{first}\n":
                fail(phase, f"exec {first}: {said!r}")
            backend, local = _free_port(), _free_port()
            pod_file = os.path.join(tmp, "http.json")
            with open(pod_file, "w") as f:
                json.dump({"kind": "Pod", "metadata": {"name": "http-0",
                                                       "labels": {"app": "http"}},
                           "spec": {"containers": [{
                               "name": "http", "image": "http",
                               "command": [sys.executable, "-c", HTTP_LAUNCHER],
                               "args": [str(backend)], "ports": [{"containerPort": backend}],
                               "readinessProbe": {"httpGet": {"path": "/", "port": backend}}}]}},
                          f)
            cli("create", "-f", pod_file)
            cli.wait_running("app=http", 1)
            forward_log = open(os.path.join(tmp, "forward.log"), "w+")
            t_forward = time.monotonic()
            forward = subprocess.Popen(cli.argv("port-forward", "http-0", f"{local}:{backend}"),
                                       cwd=REPO, env=cli.env, stdin=subprocess.DEVNULL,
                                       stdout=forward_log, stderr=subprocess.STDOUT,
                                       start_new_session=True)

            def through():
                try:
                    return _http_get(("127.0.0.1", local))
                except OSError:
                    if forward.poll() is not None:
                        fail(phase, f"port-forward exited {forward.returncode}: "
                                    f"{_log_tail(forward_log, 800)}")
                    return None

            _wait(phase, "a GET through port-forward", lambda: through() is not None,
                  KTCTL_WAIT_S, interval=0.1)
            forwarded = through()
            forward_s = time.monotonic() - t_forward
            if forwarded != (200, "http-0"):
                fail(phase, f"GET through port-forward: {forwarded}")
            forward.send_signal(signal.SIGINT)
            try:
                forward_rc = forward.wait(timeout=10)
            except subprocess.TimeoutExpired:
                fail(phase, "port-forward did not stop on SIGINT")
            forward = None
            forward_log.close()
            cli("delete", "pod", "http-0")
            # 5. scale, rolling update, stop.
            t0 = time.monotonic()
            cli("scale", "rc", "web", "--replicas", str(KTCTL_SCALED))
            cli.wait_running("app=web", KTCTL_SCALED)
            scale_to_running_s = time.monotonic() - t0
            t0 = time.monotonic()
            progress = cli("rolling-update", "web", "--image", "sleeper:v2", "--poll-interval",
                           str(KTCTL_POLL_S))
            rolling_update_s = time.monotonic() - t0
            if not progress.endswith("replicationcontroller/web rolling updated\n"):
                fail(phase, f"rolling-update said {progress[-300:]!r}")
            rc = cli.json("get", "rc", "web")
            selector = ",".join(f"{k}={v}" for k, v in sorted(rc["spec"]["selector"].items()))
            _, updated = cli.wait_running(selector, KTCTL_SCALED)
            images = {p["spec"]["containers"][0]["image"] for p in updated.values()}
            left = set(cli.pods("app=web")) - set(updated)
            if images != {"sleeper:v2"} or left:
                fail(phase, f"after the rolling update: images {images}, other pods {left}")
            t0 = time.monotonic()
            cli("stop", "rc", "web")
            stop_s = time.monotonic() - t0
            _wait(phase, "no pod in the apiserver", lambda: not cli.json("get", "pods")["items"],
                  KTCTL_WAIT_S, interval=KTCTL_POLL_S)
            _wait(phase, "no pod in the kubelets' runtimes",
                  lambda: cli("top", "pods").strip().count("\n") == 0, KTCTL_WAIT_S,
                  interval=KTCTL_POLL_S)
            stop_to_gone_s = time.monotonic() - t0
            # 6. SIGINT stops the cluster.
            t_stop = time.monotonic()
            child.proc.send_signal(signal.SIGINT)
            try:
                rc_exit = child.proc.wait(timeout=KTCTL_WAIT_S)
            except subprocess.TimeoutExpired:
                fail(phase, f"SIGINT did not stop the child in {KTCTL_WAIT_S} s: {child.tail()}")
            sigint_s = time.monotonic() - t_stop
            group = _group_members(child.proc.pid)
            if rc_exit != 0 or group or "cluster stopped" not in child.tail():
                fail(phase, f"SIGINT: exit {rc_exit}, processes left {group}: {child.tail()}")
        finally:
            if forward is not None and forward.poll() is None:
                os.killpg(forward.pid, signal.SIGKILL)
                forward.wait(timeout=10)
            child.kill()
    walls = cli.figures()
    return {
        "card": smi, "pyyaml_importable": pyyaml, "nodes": node_names,
        "replicas": KTCTL_REPLICAS, "scaled": KTCTL_SCALED, "start_to_up_s": up_s,
        "prewarm_k1_launches": settled, "k1_launches": k1,
        "create_to_running_s": create_to_running_s, "running_wait_s": running_s,
        "scale_to_running_s": scale_to_running_s, "rolling_update_s": rolling_update_s,
        "stop_s": stop_s, "stop_to_gone_s": stop_to_gone_s, "forward_first_get_s": forward_s,
        "port_forward_exit": forward_rc, "sigint_to_exit_s": sigint_s, "exit_code": rc_exit,
        "explained_node": decision.get("node"), "command_walls": walls,
        "commands": sum(v["calls"] for v in walls.values()),
        "leg_s": time.perf_counter() - t_leg,
        "timed": "host clock of this process around each CLI process (the interpreter's "
                 "start included) and from each command's start to the state it asks for, "
                 "polled with `get pods` every 0.2 s; K1's launches from the child's "
                 "/debug/kernels through `profile kernels` once the prewarm's settled and "
                 "after all Running",
    }


SOAK_NODES = 200  # the harness's default fleet
SOAK_SEED = 7
#: The epochs the leg runs unless `--soak-epochs` says otherwise: the
#: full schedule took longer than this leg's room (PERF.md section 4), so
#: the subset that keeps K1, preemption and K2 on the path.
SOAK_EPOCHS = ("baseline", "apiserver_restart", "daemon_restart_mid_gang", "preemption_storm",
               "defrag_daemon_crash", "final")


def _ledger_calls(kernel):
    """The kernel's calls on the card in the port's ledger."""
    from kubernetes_tpu_torch.ops import ledger

    return sum(r["calls"] for r in ledger.DEFAULT.rows()
               if r["kernel"] == kernel and r["impl"] == "cuda")


def _expected_firings(rule, seed, calls_at_site):
    """The per-site call indices at which the p-rule `rule` fires when
    armed over the calls `calls_at_site` (its first and last per-site
    index), from the rule and the site's seeded stream alone: what a
    second `build_schedule(seed)` arms there. The rule draws once a call
    from `Random(f"{seed}:{site}")` until its budget is spent."""
    import random

    first, last = calls_at_site
    rng = random.Random(f"{seed}:{rule['site']}")
    times = rule.get("times")
    out = []
    for call in range(first, last + 1):
        if times is not None and len(out) >= times:
            break
        if rng.random() < rule["p"]:
            out.append(call)
    return out


class _SoakSteps:
    """Seconds in each of the soak's driver verbs, checks and restarts
    while in the block, summed by name: where an epoch's wall goes."""

    STEPS = {
        "ChurnDriver": ("create_pods", "reconcile_missing", "wait_bound", "delete_pods",
                        "delete_group"),
        "InvariantChecker": ("quiesce", "_check_store_vs_mirror", "_check_gangs",
                             "_check_nominations", "_check_move_journal", "_check_slo_epoch",
                             "_check_capacity_epoch", "_check_alerts_epoch"),
        "SoakCluster": ("restart_apiserver", "restart_scheduler"),
    }

    def __init__(self, soak):
        self.soak, self.seconds, self._saved = soak, {}, []

    def __enter__(self):
        for cls_name, names in self.STEPS.items():
            cls = getattr(self.soak, cls_name)
            for name in names:
                fn = getattr(cls, name)
                self._saved.append((cls, name, fn))
                setattr(cls, name, self._timed(name, fn))
        return self

    def _timed(self, name, fn):
        def call(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                self.seconds[name] = self.seconds.get(name, 0.0) + time.perf_counter() - t0
        return call

    def __exit__(self, *exc):
        for cls, name, fn in self._saved:
            setattr(cls, name, fn)


def _k2_count():
    """K2's wrapper count (a CPU dry run patches it, as `_k1_count`)."""
    from kubernetes_tpu_torch.ops import rebalance

    return rebalance.plan_moves.launches


def run_soak_leg(torch, device, smi, soak_epochs=""):
    """Leg soak: the port's whole control plane through the soak's
    seeded fault schedule, in this process, on the card, sanitized."""
    import tempfile

    from kubernetes_tpu_torch import soak
    from kubernetes_tpu_torch.ops import rebalance
    from kubernetes_tpu_torch.utils import capacity, faults, flightrecorder, sanitizer
    from kubernetes_tpu_torch.utils import rebalance as rebal_utils

    phase = "soak"
    if soak_epochs == "all":
        epochs = list(soak.EPOCHS)
    else:
        epochs = list(filter(None, soak_epochs.split(","))) or list(SOAK_EPOCHS)
    # The process-wide monitors at their defaults: earlier legs set the
    # slice shapes and the recorder's limits.
    capacity.DEFAULT.reset()
    rebal_utils.DEFAULT.reset()
    _fresh_recorder()
    flightrecorder.DEFAULT.clear()
    sanitizer.enable()
    sanitizer.reset()
    k1_calls0, k2_calls0 = _ledger_calls("scan_kernel"), _ledger_calls("rebalance_kernel")
    threads0 = {t.ident for t in threading.enumerate()}
    on_card = torch.device(device).type == "cuda"
    mem0 = torch.cuda.memory_allocated() if on_card else 0
    _k1_set(0)
    rebalance.plan_moves.launches = 0
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="soak-leg-") as data_dir, _SoakSteps(soak) as steps:
        art = soak.run_soak(n_nodes=SOAK_NODES, seed=SOAK_SEED, epochs=epochs,
                            data_dir=data_dir, fsync=True, verbose=False, device=device)
    wall = time.perf_counter() - t0

    def fresh(daemon):
        return [t.name for t in threading.enumerate()
                if t.ident not in threads0 and t.is_alive() and t.daemon == daemon]

    _wait(phase, "the soak's non-daemon threads to end", lambda: not fresh(False), timeout=10)
    if on_card:
        torch.cuda.synchronize()
    mem_left = (torch.cuda.memory_allocated() - mem0) if on_card else 0
    k1, k2 = _k1_count(), _k2_count()
    k1_calls = _ledger_calls("scan_kernel") - k1_calls0
    k2_calls = _ledger_calls("rebalance_kernel") - k2_calls0
    found, leaked = sanitizer.findings(), sanitizer.leaked_locks()
    edges, locks = sanitizer.edges(), sanitizer.held_locks()
    lock_names = sorted({n for e in edges for n in (e["from"], e["to"])})
    sanitizer.disable()
    if art["invariant_violations"]:
        fail(phase, f"invariant violations: {art['invariant_violations'][:5]}")
    if found or leaked:
        fail(phase, f"sanitizer findings {found[:3]}, locks held by dead threads {leaked[:5]}")
    if faults.enabled():
        fail(phase, "the fault registry is still armed")
    want_api = sum(e in epochs for e in ("apiserver_restart", "leader_kill_each_tier"))
    if art["restarts"]["apiserver"] != want_api or art["restarts"]["scheduler"] < 1:
        fail(phase, f"restarts {art['restarts']}, want {want_api} apiserver and a daemon")
    if k1_calls <= 0 or k2_calls <= 0 or k1 <= 0 or k2 <= 0:
        fail(phase, f"K1 {k1_calls} ledger calls ({k1} launches), K2 {k2_calls} ({k2})")
    # The alert oracle, read from the transitions: every declared rule
    # went to firing, and each one's last transition is a resolve.
    timeline = art["alerts"]["timeline"]
    expected = sorted({r for e in art["schedule"] for r in e.get("expected_alerts", ())})
    for rule in expected:
        moves = [t for t in timeline if t["rule"] == rule]
        if not any(t["to"] == "firing" for t in moves) or moves[-1]["to"] != "resolved":
            fail(phase, f"alert {rule}: transitions {moves}")
    if art["alerts"]["firing_at_end"]:
        fail(phase, f"still firing: {art['alerts']['firing_at_end']}")
    # The realized firings against a second build_schedule(seed).
    schedule = soak.build_schedule(SOAK_SEED, epochs, n_nodes=SOAK_NODES)
    if schedule != art["schedule"]:
        fail(phase, "build_schedule is not pure")
    fired_at: dict = {}
    for site, call in art["fault_timeline"]:
        fired_at.setdefault(site, []).append(call)
    armed = {e["rule"]["site"]: e["rule"] for e in schedule if "rule" in e}
    if set(fired_at) - set(armed):
        fail(phase, f"sites fired that no rule armed: {sorted(set(fired_at) - set(armed))}")
    firings = {}
    for site, rule in armed.items():
        got = fired_at.get(site, [])
        firings[site] = len(got)
        if rule.get("times") == 1 and len(got) != 1:
            fail(phase, f"{site} fired {len(got)} times, its epoch needs 1")
        if rule.get("times") is not None and len(got) > rule["times"]:
            fail(phase, f"{site} fired {len(got)} times past its budget {rule['times']}")
        if got and rule.get("every", 0) > 0:
            # The site's calls count from the run's start, armed or not:
            # the rule fires at consecutive multiples of `every` from
            # the first one after its arming.
            want = list(range(got[0], got[0] + rule["every"] * len(got), rule["every"]))
            if got[0] % rule["every"] or got != want:
                fail(phase, f"{site} fired at {got}, its rule at {want}")
        elif got:
            # A p-rule draws once a call while armed: the gaps between its
            # firings are those between the draws under p.
            want = _expected_firings(rule, SOAK_SEED, (got[0], got[0] + 100000))
            shift = got[0] - want[0]
            if [c + shift for c in want[:len(got)]] != got:
                fail(phase, f"{site} fired at {got}, its seeded stream at "
                            f"{[c + shift for c in want[:len(got)]]}")
    return {
        "card": smi, "nodes": SOAK_NODES, "seed": SOAK_SEED, "epochs": epochs,
        "epoch_walls_s": {e["epoch"]: e["wall_s"] for e in art["epochs"]},
        "pods_bound": art["pods_bound"], "bind_p50_s": art["bind_p50_s"],
        "bind_p99_s": art["bind_p99_s"], "post_fault_bind_p99_s": art["post_fault_bind_p99_s"],
        "restarts": art["restarts"], "firings": firings,
        "fault_calls": {k: v["calls"] for k, v in art["faults_injected"].items()},
        "alerts_fired": expected, "k1_launches": k1, "k2_launches": k2,
        "k1_ledger_calls": k1_calls, "k2_ledger_calls": k2_calls,
        "sanitizer": {"locks": len(lock_names), "edges": len(edges), "held_at_end": len(locks),
                      "lock_names": lock_names},
        "failover_to_first_bind_s": art["failover_to_first_bind_s"],
        "rebalance_cycles": len(art["rebalance_cycles"]),
        "daemon_threads_left": len(fresh(True)), "card_bytes_left": mem_left,
        "soak_wall_s": art["wall_s"], "leg_s": wall,
        "step_seconds": {k: round(v, 3) for k, v in sorted(steps.seconds.items())},
        "timed": "host clock of this process: each epoch from its arming to its invariant "
                 "check's end; binds by the soak's watch mirror",
    }


def run_daemon(torch, device, smi, legs=(), churn_stuck=0, soak_epochs=""):
    """The twenty-five legs, the first twenty-four each on a fresh
    apiserver child, the soak in this process (only `legs` when given).
    `churn_stuck` pods that fit no node wait through daemon_churn's
    load; `soak_epochs` as `--soak-epochs`."""
    plan = {
        "daemon_parity": lambda: {"card": smi, **run_daemon_parity(torch, device)},
        "daemon_parity_wide": lambda: run_daemon_parity(torch, device, wide=True),
        "daemon_drill": lambda: run_daemon_drill(torch, device, smi, "daemon_drill"),
        "daemon_churn": lambda: run_daemon_drill(torch, device, smi, "daemon_churn",
                                                 preload=CHURN_PRELOAD, stuck=churn_stuck),
        "daemon_parity_hostnames": lambda: run_daemon_parity(torch, device, wide=True,
                                                             n_nodes=HOSTNAME_NODES),
        "daemon_policy_parity": lambda: run_daemon_policy_parity(torch, device),
        "daemon_policy_drill": lambda: run_daemon_drill(torch, device, smi,
                                                        "daemon_policy_drill", policy=True),
        "daemon_sidecar_parity": lambda: run_daemon_sidecar_parity(torch, device),
        "desched_defrag": lambda: run_desched_defrag(torch, device, smi),
        "autoscale_cycle": lambda: run_autoscale_cycle(torch, device, smi),
        "daemon_debug": lambda: run_daemon_debug(torch, device, smi),
        "daemon_failover": lambda: run_daemon_failover(torch, device, smi),
        "daemon_ha": lambda: run_daemon_ha(torch, device, smi),
        "daemon_ha_cmd": lambda: run_daemon_ha_cmd(torch, device, smi),
        "daemon_scalar": lambda: run_daemon_scalar(torch, device, smi),
        "apiserver_durable": lambda: run_apiserver_durable(torch, device, smi),
        "apiserver_replicated": lambda: run_apiserver_replicated(torch, device, smi),
        "controller_rc": lambda: run_controller_rc(torch, device, smi),
        "controller_node_loss": lambda: run_controller_node_loss(torch, device, smi),
        "kubelet_density": lambda: run_kubelet_density(torch, device, smi),
        "kubelet_service": lambda: run_kubelet_service(torch, device, smi),
        "cloud_controllers": lambda: run_cloud_controllers(torch, device, smi),
        "local_up": lambda: run_local_up(torch, device, smi),
        "ktctl": lambda: run_ktctl(torch, device, smi),
        "soak": lambda: run_soak_leg(torch, device, smi, soak_epochs),
    }
    unknown = set(legs) - set(plan)
    if unknown:
        fail("daemon", f"no such legs: {sorted(unknown)}")
    out = {}
    for name, run in plan.items():
        if not legs or name in legs:
            out[name] = run()
            emit(name, ok=True, **out[name])
    return out


# ---------------------------------------------------------------------------
# Phase 6: kernel time and bound at the main path's shape
# ---------------------------------------------------------------------------


def _time_ms(torch, pods, carry, plan=None, reps=3, warm=True):
    """Median CUDA-event milliseconds of `reps` launches (after one
    warm-up launch when `warm`), each from a fresh copy of `carry`.
    Returns (median, all times, the last launch's (choice, nodes))."""
    from kubernetes_tpu_torch.ops import scan_kernel

    times, out = [], None
    for _ in range(reps + (1 if warm else 0)):
        nodes = _copy(carry)
        torch.cuda.synchronize()
        ev0, ev1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        ev0.record()
        out = scan_kernel._launch(pods, nodes, (1, 1, 1), plan)
        ev1.record()
        torch.cuda.synchronize()
        times.append(ev0.elapsed_time(ev1))
    if warm:
        times = times[1:]  # the first call warms the caches
    return statistics.median(times), times, out


def _ptxas_figures(log: str):
    """The most registers any instance of the scan kernel uses, and the
    spill bytes (stores + loads) of all of them."""
    import re

    regs = re.findall(r"Used (\d+) registers", log)
    spills = re.findall(r"(\d+) bytes spill stores, (\d+) bytes spill loads", log)
    return (
        max(int(x) for x in regs) if regs else None,
        sum(int(x) + int(y) for x, y in spills) if spills else None,
    )


def _bound(cost, **extra):
    """The bound of one launch from its bytes and 32-bit operations
    (the kernel module's `cost`): the larger of bytes over the HBM rate
    and operations over the f32 rate."""
    bytes_ms = cost["bytes_accessed"] / HBM_BYTES_PER_S * 1e3
    ops_ms = cost["flops"] / F32_OPS_PER_S * 1e3
    return {"bytes": cost["bytes_accessed"], "ops": cost["flops"], **extra,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


def kernel_bound(torch, pods, carry):
    """The least time the card could take for one scan launch on these
    inputs: `scan_kernel.cost` over the pods some node could take (the
    padding rows, pinned to -2, need no pair)."""
    from kubernetes_tpu_torch.ops import scan_kernel

    P, N = pods["cpu"].shape[0], carry["cpu_cap"].shape[0]
    pin = pods["pinned"]
    placeable = int(((pin == -1) | ((pin >= 0) & (pin < N))).sum().item())
    cost = scan_kernel.cost(P, N, carry["svc_counts"].shape[1], pods["sel"].shape[1],
                            pods["port"].shape[1], pods["vol_any"].shape[1],
                            pods["svc_ids"].shape[1], placeable)
    return _bound(cost, placeable_pods=placeable)


def time_kernel(torch, device, chunk_state, chunk_result, ptxas):
    from kubernetes_tpu_torch.ops import scan_kernel

    pods, carry0 = chunk_state
    ref, ref_nodes = chunk_result
    P, N = pods["cpu"].shape[0], carry0["cpu_cap"].shape[0]
    SW, PW = pods["sel"].shape[1], pods["port"].shape[1]
    VW, K = pods["vol_any"].shape[1], pods["svc_ids"].shape[1]
    S = carry0["svc_counts"].shape[1]
    ms, times, _ = _time_ms(torch, pods, carry0, None, KERNEL_REPEATS)
    plan = scan_kernel.plan_for(pods, carry0)
    regs, spills = _ptxas_figures(ptxas)

    def launch_line(cfg, n_nodes, t):
        line = {
            "cluster": cfg.cluster, "threads": cfg.threads, "nodes": n_nodes,
            "nodes_per_cta": cfg.nodes_per_cta, "smem_bytes": cfg.smem_bytes,
            "max_active_clusters": scan_kernel.occupancy(cfg, n_nodes, SW, PW, VW, K),
            "registers": regs, "spill_bytes": spills, "default": cfg == plan,
            "ms": t, "per_pod_us": t * 1e3 / P,
        }
        emit("launch", ok=True, **line)
        return line

    # The same pods against the first n nodes only: how the time per pod
    # splits into a fixed part (barriers, reductions, commit) and a part
    # that grows with the nodes each thread walks.
    per_pod_us = {}
    for n in (1024, 2048, 4096):
        part = {k: v[:n].clone() for k, v in carry0.items()}
        t, _, _ = _time_ms(torch, pods, part, None, 2)
        per_pod_us[n] = t * 1e3 / P
    per_pod_us[N] = ms * 1e3 / P

    # Cluster size and threads per CTA on the whole chunk. Each
    # configuration's decisions and carry must equal the checked ones.
    sweep = [launch_line(plan, N, ms)]
    for C, T in ((8, 320), (8, 640), (16, 160), (16, 640)):
        cfg = scan_kernel.plan_for(pods, carry0, C, T)
        t, _, (got, nodes) = _time_ms(torch, pods, carry0, cfg, 2)
        _compare(torch, f"cluster of {C} x {T} threads", got, nodes, ref, ref_nodes)
        sweep.append(launch_line(cfg, N, t))


    # No service ids: no commit changes a count (other decisions, the
    # same shape of work), so the difference is what the counts cost.
    count_steps = int(((ref >= 0) & (pods["svc_ids"] >= 0).any(dim=1)).sum().item())
    no_ids = dict(pods, svc_ids=torch.full_like(pods["svc_ids"], -1))
    ms_no_ids, _, _ = _time_ms(torch, no_ids, carry0, None, 2)

    # A node axis near the shared-memory limit, timed once: the chunk's
    # nodes repeated up to max_nodes.
    n_max = scan_kernel.max_nodes(SW, PW, VW, K)
    big = {k: torch.cat([v] * -(-n_max // N))[:n_max].contiguous() for k, v in carry0.items()}
    ms_big, _, _ = _time_ms(torch, pods, big, None, 1, warm=False)
    near_limit = launch_line(scan_kernel.plan_for(pods, big), n_max, ms_big)

    bound = kernel_bound(torch, pods, carry0)
    return {
        "shape": {"P": P, "N": N, "S": S, "SW": SW, "PW": PW, "VW": VW, "K": K},
        "plan": {"cluster": plan.cluster, "threads": plan.threads,
                 "nodes_per_cta": plan.nodes_per_cta, "smem_bytes": plan.smem_bytes},
        "ms": ms,
        "per_pod_us_by_nodes": per_pod_us,
        "fixed_part_us": per_pod_us[1024],
        "ms_all": times,
        "sweep": [{k: x[k] for k in ("cluster", "threads", "ms", "per_pod_us")} for x in sweep],
        "placeable_pods": bound["placeable_pods"],
        "count_commit_steps": count_steps,
        "ms_no_service_ids": ms_no_ids,
        "near_limit": {k: near_limit[k] for k in ("nodes", "cluster", "threads", "smem_bytes", "ms", "per_pod_us")},
        "bytes": bound["bytes"],
        "ops": bound["ops"],
        "bound_ms": bound["bound_ms"],
        "bound_by": bound["bound_by"],
        "timed": "the wrapper's launch on the first pipeline chunk, layout conversion included",
    }


# ---------------------------------------------------------------------------
# Phase 5p: the node-sharded mesh
# ---------------------------------------------------------------------------

MESH_SHARDS = 4
MESH_CHUNK_PODS = 4096  # pods of the 50k backlog K1S is held and timed on
MESH_REPEATS = 2  # timed K1S runs on that chunk
MESH_CHECK = (8192, 1024, 7)  # pods, nodes, seed of the auto-mode and validity backlog


def mesh_devices(torch):
    """The shards' devices: cuda:0-3 with four or more cards, else all
    four shards on cuda:0; and the words that say which."""
    if torch.cuda.device_count() >= MESH_SHARDS:
        devices = tuple(torch.device("cuda", i) for i in range(MESH_SHARDS))
        return devices, f"{MESH_SHARDS} shards on cuda:0-{MESH_SHARDS - 1}"
    return (torch.device("cuda", 0),) * MESH_SHARDS, f"{MESH_SHARDS} shards on cuda:0"


def _sync_mesh(torch, mesh):
    for dev in set(mesh.devices):
        torch.cuda.synchronize(dev)


def _mesh_timed(torch, mesh, fn):
    """(result, ms by CUDA events on the mesh's first device, host
    seconds) of fn(), every device synchronised before and after. The
    first device's stream waits on every cross-device copy, so its
    events span the other devices' work too."""
    _sync_mesh(torch, mesh)
    ev0, ev1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    with torch.cuda.device(mesh.first):
        ev0.record()
        out = fn()
        ev1.record()
    _sync_mesh(torch, mesh)
    return out, ev0.elapsed_time(ev1), time.perf_counter() - t0


def run_mesh(torch, device, smi):
    """Phase 5p (see the module text)."""
    import numpy as np

    from kubernetes_tpu_torch import workload
    from kubernetes_tpu_torch.models.columnar import SnapshotBuilder, build_snapshot
    from kubernetes_tpu_torch.ops import scan_kernel, shard_scan, sinkhorn
    from kubernetes_tpu_torch.ops.matrices import (
        ShardedNodes, device_nodes, device_pods, device_snapshot, host_mesh, shard_nodes)
    from kubernetes_tpu_torch.ops.pipeline import solve_backlog_pipelined
    from kubernetes_tpu_torch.ops.wave import strip_assignments
    from kubernetes_tpu_torch.scheduler import batch

    devices, kind = mesh_devices(torch)
    mesh = host_mesh(MESH_SHARDS, devices=devices)
    if mesh is None:
        fail("mesh", f"host_mesh({MESH_SHARDS}, devices={devices}) formed no mesh")
    emit("mesh_devices", ok=True, mesh=kind, device_count=torch.cuda.device_count(),
         devices=[str(d) for d in devices], card=smi)
    for dev in set(devices):
        torch.cuda.reset_peak_memory_stats(dev)
    out = {"mesh": kind, "device_count": torch.cuda.device_count(), "shards": MESH_SHARDS}

    # -- K1S on the first chunk: against its plain version and against K1 ----
    pending, nodes, services = workload.synthetic_objects(N_PODS, N_NODES, seed=2)
    builder = SnapshotBuilder(pending, nodes, (), services)
    flat = device_nodes(builder.node_columns(), mesh.first)
    pods = device_pods(builder.pod_columns(0, MESH_CHUNK_PODS), mesh.first)
    ref, ref_nodes = scan_kernel.scan_with_state(pods, _copy(flat))
    _, k1_ms, _ = _mesh_timed(torch, mesh, lambda: scan_kernel.scan_with_state(pods, _copy(flat)))
    (got, got_nodes), k1s_ms, k1s_s = _mesh_timed(
        torch, mesh, lambda: shard_scan.sharded_scan_with_state(pods, shard_nodes(flat, mesh)))
    err = _compare(torch, "K1S against K1's unsharded solve", got, got_nodes.stitched(), ref,
                   ref_nodes, phase="mesh")
    (plain, plain_nodes), plain_ms, plain_s = _mesh_timed(
        torch, mesh,
        lambda: shard_scan.plain_sharded_scan_with_state(pods, shard_nodes(flat, mesh)))
    err = max(err, _compare(torch, "K1S against its plain version", got, got_nodes.stitched(),
                            plain, plain_nodes.stitched(), phase="mesh"))
    times = [k1s_ms]
    for _ in range(MESH_REPEATS - 1):
        (again, again_nodes), t, _ = _mesh_timed(
            torch, mesh, lambda: shard_scan.sharded_scan_with_state(pods, shard_nodes(flat, mesh)))
        _compare(torch, "K1S repeated", again, again_nodes.stitched(), ref, ref_nodes,
                 phase="mesh")
        times.append(t)
    ms = statistics.median(times)
    P, N = pods["cpu"].shape[0], flat["cpu_cap"].shape[0]
    pin = pods["pinned"]
    placeable = int(((pin == -1) | ((pin >= 0) & (pin < N))).sum().item())
    bound = _bound(shard_scan.cost(
        P, N, flat["svc_counts"].shape[1], pods["sel"].shape[1], pods["port"].shape[1],
        pods["vol_any"].shape[1], pods["svc_ids"].shape[1], MESH_SHARDS, placeable),
        placeable_pods=placeable)
    out["k1s"] = {
        "pods": P, "nodes": N, "nodes_per_shard": N // MESH_SHARDS,
        "threads": shard_scan.threads_for(N // MESH_SHARDS),
        "ms": ms, "ms_all": times, "us_per_pod": ms * 1e3 / P, "host_s_first": k1s_s,
        "plain_ms": plain_ms, "plain_host_s": plain_s, "max_abs_err": err,
        "k1_ms_same_pods": k1_ms,
        "tolerance": "exact (torch.equal), decisions and the nine carry fields",
        **bound,
        "timed": "the wrapper's whole chain on the chunk (P + 2 launches a shard and the "
                 "slots' exchange), CUDA events on the first device",
    }

    # -- the main path of the phase: a user's sharded scan, its K1S launches ----
    chunk = pending[:MESH_CHUNK_PODS]
    k1_before = scan_kernel.scan_with_state.launches
    shard_scan.sharded_scan_with_state.launches = 0
    t0 = time.perf_counter()
    names = batch.schedule_backlog(chunk, nodes, (), services, mesh=mesh)
    _sync_mesh(torch, mesh)
    sharded_s = time.perf_counter() - t0
    launches = shard_scan.sharded_scan_with_state.launches
    if launches == 0:
        fail("mesh", "schedule_backlog(mesh=) launched K1S no time")
    if scan_kernel.scan_with_state.launches != k1_before:
        fail("mesh", "schedule_backlog(mesh=) fell back to K1's unsharded solve")
    t0 = time.perf_counter()
    want = batch.schedule_backlog(chunk, nodes, (), services, device=device)
    flat_s = time.perf_counter() - t0
    if names != want:
        bad = sum(a != b for a, b in zip(names, want))
        fail("mesh", f"schedule_backlog(mesh=): {bad} of {len(want)} pods differ from the "
                     "unsharded scan")
    out["schedule_backlog"] = {"pods": len(chunk), "wall_s": sharded_s, "unsharded_wall_s": flat_s,
                               "k1s_launches": launches,
                               "placed": sum(n is not None for n in names)}
    out["launches"] = launches

    # -- the wave and Sinkhorn over the whole 50k x 5k backlog ------------------
    for mode in ("wave", "sinkhorn"):
        t0 = time.perf_counter()
        sharded = solve_backlog_pipelined(pending, nodes, (), services, mode=mode, mesh=mesh)
        _sync_mesh(torch, mesh)
        wall = time.perf_counter() - t0
        t0 = time.perf_counter()
        unsharded = solve_backlog_pipelined(pending, nodes, (), services, mode=mode, device=device)
        flat_wall = time.perf_counter() - t0
        agree = float(np.mean([a == b for a, b in zip(sharded, unsharded)]))
        if mode == "wave" and agree < 1.0:
            fail("mesh", f"the sharded wave differs from the unsharded one on "
                         f"{1 - agree:.6f} of the pods")
        if agree < AGREEMENT:
            fail("mesh", f"sharded Sinkhorn agrees with the unsharded one on {agree:.4f} only")
        out[mode] = {"pods": N_PODS, "nodes": N_NODES, "wall_s": wall, "unsharded_wall_s": flat_wall,
                     "agreement": agree, "placed": sum(n is not None for n in sharded)}

    # Sinkhorn's sharded prices against the unsharded ones, on the card.
    worst = 0.0
    for seed in range(4):
        masked, valid, capacity = _congested_matrix(seed)
        m, v, c = (torch.from_numpy(x).to(mesh.first) for x in (masked, valid, capacity))
        g, i, r = sinkhorn._congestion_prices(m, v, c, 2.0, 20, 0.0)
        cut = [torch.from_numpy(x).to(mesh.first)
               for x in np.array_split(np.arange(masked.shape[1]), MESH_SHARDS)]
        holder = ShardedNodes(mesh, [{"cpu_cap": torch.zeros(len(x), device=dev)}
                                     for x, dev in zip(cut, mesh.devices)])
        gs, is_, rs = sinkhorn._congestion_prices_sharded(
            [m[:, x].to(dev) for x, dev in zip(cut, mesh.devices)], v,
            [c[x].to(dev) for x, dev in zip(cut, mesh.devices)], holder, 2.0, 20, 0.0)
        perr = float((torch.cat([x.to(mesh.first) for x in gs]) - g).abs().max())
        rerr = abs(float(rs) - float(r))
        if int(is_) != int(i) or perr > PRICE_ATOL or rerr > PRICE_ATOL:
            fail("mesh", f"sharded prices, congested seed {seed}: iterations {int(is_)} and "
                         f"{int(i)}, price error {perr}, residual error {rerr}")
        worst = max(worst, perr, rerr)
    out["sinkhorn"]["price_max_abs_err"] = worst

    # -- auto on a mesh picks the wave; Sinkhorn's placements are valid --------
    mode = batch.resolve_batch_mode("auto", mesh)
    if mode != "wave":
        fail("mesh", f"resolve_batch_mode('auto', mesh) resolved to {mode!r}, not the wave")
    n_pods, n_nodes, seed = MESH_CHECK
    cpending, cnodes, cservices = workload.synthetic_objects(n_pods, n_nodes, seed=seed)
    solver = {"wave": batch.schedule_backlog_wave}[mode]
    t0 = time.perf_counter()
    got_names = solver(cpending, cnodes, (), cservices, mesh=mesh)
    auto_s = time.perf_counter() - t0
    if got_names != solver(cpending, cnodes, (), cservices, device=device):
        fail("mesh", "schedule_backlog_wave(mesh=) differs from the unsharded wave")
    snap = build_snapshot(cpending, cnodes, services=cservices)
    d = device_snapshot(snap, mesh=mesh)
    a, _ = sinkhorn.solve_sinkhorn(d.pods, d.nodes)
    _valid("mesh", snap, strip_assignments(d, a), "sharded Sinkhorn")
    out["auto"] = {"resolved": mode, "pods": n_pods, "nodes": n_nodes, "wall_s": auto_s,
                   "placed": sum(n is not None for n in got_names),
                   "sinkhorn_valid_on": f"{n_pods} x {n_nodes}"}
    out["peak_memory_bytes"] = {str(dev): torch.cuda.max_memory_allocated(dev)
                                for dev in set(devices)}
    return out


def mesh_kernel_line(mesh):
    """K1S's entry of the kernels line, from phase 5p's result."""
    k = mesh["k1s"]
    return {
        "name": "shard_scan_kernel",
        "route": "cuda",
        "source": "kubernetes_tpu_torch/csrc/shard_scan_kernel.cu",
        # An XLA function of the JAX package under a mesh, not a Pallas kernel.
        "replaces": "kubernetes_tpu/ops/solver.py:304 (_scan_solve under a mesh; XLA, "
                    "not a Pallas kernel)",
        "launches": mesh["launches"],
        "launches_by_path": {"mesh_schedule_backlog": mesh["launches"]},
        "max_abs_err": k["max_abs_err"],
        "ms": k["ms"],
        "plain_ms": k["plain_ms"],
        "bound_ms": k["bound_ms"],
        "bound_by": k["bound_by"],
        # No single PyTorch call computes the sequential solve.
        "library_ms": None,
        "us_per_pod": k["us_per_pod"],
        "mesh": mesh["mesh"],
    }


if __name__ == "__main__":
    sys.exit(main())
