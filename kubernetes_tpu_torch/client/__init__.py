"""The apiserver client: REST transports, watch-fed caches, events."""
