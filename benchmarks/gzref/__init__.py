"""The benchmark's plain reference: what a compress, a decompress and a GFF3
search of given records must produce, worked out from the records alone.

Plain NumPy and PyTorch.  It imports nothing of the program under test and
takes nothing the program made; where it reads a program's output (the
`.gcz` block chain, a FASTA, GFF3 rows) it does so only to judge it.
"""
