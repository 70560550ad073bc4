"""The from-scratch deflate codec and the gzip/BGZF container: the port's
copy of gecoz_tpu/codec/."""
