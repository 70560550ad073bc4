"""The .gcz/.gcx container and FASTA (copies of gecoz_tpu/formats)."""
