"""Block planning: the reference's chromosome-capped merge policy.

The port's copy of gecoz_tpu/tools/blocks.py: the same code,
its imports pointed at gecoz_tpu_torch, so that the port imports
nothing of the JAX package.

Mirrors GecoIndex.index (nova-gecoz tools/GecoIndex.java:57-98):

1. one block per sequence, ordered by (size asc, first-sequence compare);
   sequences inside a block are ordered longest-first, ties by header
   (TFastaSequence.compareTo:46-52);
2. repeatedly fuse the two smallest blocks while the fused size does not
   exceed the largest initial block; stop at the FIRST failure (the
   reference `break`s out of the loop, it does not keep trying);
3. emit blocks ordered by largest-sequence length desc, ties by
   (size asc, first-sequence) (GecoIndex.java:88-98).

Block sizes count one ``\\0`` terminator per sequence
(GecozRefBlock.java:43-57).

This static, size-balanced plan is also the multi-chip schedule: blocks are
the unit of data parallelism across a TPU mesh (largest first).
"""

from __future__ import annotations

from dataclasses import dataclass, field

from gecoz_tpu_torch.formats.fasta import FastaSequence


@dataclass
class BlockPlan:
    sequences: list[FastaSequence] = field(default_factory=list)
    size: int = 0

    def add(self, seq: FastaSequence) -> None:
        self.sequences.append(seq)
        self.sequences.sort(key=lambda s: s.sort_key())
        self.size += seq.length + 1

    def sort_key(self):
        """GecozRefBlock.compareTo: size asc, then first sequence."""
        return (self.size,) + self.sequences[0].sort_key()

    @property
    def headers(self) -> list[str]:
        return [s.header for s in self.sequences]


def plan_blocks(sequences: list[FastaSequence]) -> list[BlockPlan]:
    blocks = [BlockPlan([s], s.length + 1) for s in sequences]
    for b in blocks:
        b.sequences.sort(key=lambda s: s.sort_key())
    blocks.sort(key=BlockPlan.sort_key)
    if not blocks:
        return []

    max_size = blocks[-1].size
    while len(blocks) > 1:
        first = blocks.pop(0)
        second = blocks.pop(0)
        fused = first.size + second.size
        if 0 < fused <= max_size:
            for s in second.sequences:
                first.add(s)
            _insort(blocks, first)
        else:
            _insort(blocks, first)
            _insort(blocks, second)
            break

    # output order: largest single sequence first
    blocks.sort(key=lambda b: (-b.sequences[0].length,) + b.sort_key())
    return blocks


def _insort(blocks: list[BlockPlan], b: BlockPlan) -> None:
    import bisect
    keys = [x.sort_key() for x in blocks]
    blocks.insert(bisect.bisect_left(keys, b.sort_key()), b)
