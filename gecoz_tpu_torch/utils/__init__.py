"""Device selection, phase metrics, bit streams and host memory."""
