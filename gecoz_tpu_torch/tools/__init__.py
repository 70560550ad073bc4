"""Drivers: FASTA -> .gcz/.gcx."""
