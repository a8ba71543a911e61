"""The benchmark's own machinery: registry, traffic, traces, counters."""
