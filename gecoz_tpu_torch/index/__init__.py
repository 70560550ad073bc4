"""Host FM-index structures (copies of gecoz_tpu/index)."""
