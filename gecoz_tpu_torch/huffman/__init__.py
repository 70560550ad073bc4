"""Huffman code lengths and deflate code tables (gecoz_tpu/huffman)."""
