"""The benchmark harness of gecoz_tpu_torch: data from the seed, the
operations a cell's traffic runs, the measured window, the trace and the
judge.  A configuration, a traffic mix and a per-layer metric are data or a
small reader each, found by the names `BENCHMARK.json` gives."""
