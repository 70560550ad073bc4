"""Block planning: the reference's chromosome-capped merge policy.

The port's plan is gecoz_tpu/tools/blocks.py's, block for block and
sequence for sequence, computed in O(n log n): a heap stands in for the
sorted list that the reference bisects into, and a block's sequences are
ordered once, when the plan is done.

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

Blocks of equal keys come off the heap in the reference's list order: the
initial blocks in input order, behind every fused block, and a fused block
ahead of those already there (the reference inserts with `bisect_left`).

This static, size-balanced plan is also the multi-chip schedule: blocks are
the unit of data parallelism across a TPU mesh (largest first).
"""

from __future__ import annotations

import heapq
from dataclasses import dataclass, field

from gecoz_tpu_torch.formats.fasta import FastaSequence


@dataclass
class BlockPlan:
    sequences: list[FastaSequence] = field(default_factory=list)
    size: int = 0

    def sort_key(self):
        """GecozRefBlock.compareTo: size asc, then first sequence."""
        return (self.size,) + self.sequences[0].sort_key()

    @property
    def headers(self) -> list[str]:
        return [s.header for s in self.sequences]


def plan_blocks(sequences: list[FastaSequence]) -> list[BlockPlan]:
    if not sequences:
        return []
    # heap entries: (size, first sequence's key, order among equal keys,
    # merge tree); initial blocks order by input position
    heap = [(s.length + 1, s.sort_key(), i, s)
            for i, s in enumerate(sequences)]
    heapq.heapify(heap)
    max_size = max(e[0] for e in heap)
    fused = 0
    while len(heap) > 1:
        first, second = heapq.heappop(heap), heapq.heappop(heap)
        size = first[0] + second[0]
        if not 0 < size <= max_size:
            # put both back as the reference does, first then second
            heapq.heappush(heap, first[:2] + (-fused - 1, first[3]))
            heapq.heappush(heap, second[:2] + (-fused - 2, second[3]))
            break
        fused += 1
        heapq.heappush(heap, (size, min(first[1], second[1]), -fused,
                              (first[3], second[3])))

    blocks = [BlockPlan(sorted(_leaves(e[3]), key=lambda s: s.sort_key()),
                        e[0]) for e in sorted(heap)]
    # output order: largest single sequence first
    blocks.sort(key=lambda b: (-b.sequences[0].length,) + b.sort_key())
    return blocks


def _leaves(tree) -> list[FastaSequence]:
    """A merge tree's sequences, the first block's before the second's:
    the order in which the reference appends them, which its stable sorts
    keep among sequences of equal keys."""
    out, stack = [], [tree]
    while stack:
        node = stack.pop()
        if isinstance(node, tuple):
            stack += (node[1], node[0])
        else:
            out.append(node)
    return out
