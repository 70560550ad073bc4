"""Drivers on the card: FASTA -> .gcz/.gcx, .gcz -> FASTA, GFF3 search.

Port of gecoz_tpu/tools/driver.py: `index_fasta` (26-113), one block at a
time; `decompress` (223-365), the reference's `--backend device` route;
and the device branch of `gff_search` (421-466).  The block plan, FASTA
reading and reflow, arena warm-up, phase metrics, `--resume` scan and GFF3
rows are gecoz_tpu's own.  The reference's batched mesh route
(driver.py:71-85 -> parallel/mesh.py) is multi-GPU work (ROADMAP A9), and
the encode's host thread pool has no counterpart: the card encodes one
block after another.  There is no host fallback: a failure on the card
raises.
"""

from __future__ import annotations

import logging
import sys
import time
from pathlib import Path

import numpy as np
import torch

from gecoz_tpu.formats.fasta import (iter_fasta, read_sequence, record_size,
                                     write_fasta_segment)
from gecoz_tpu.formats.gcz import DEFAULT_SAMPLING_RATE, GecozReader
from gecoz_tpu.tools.blocks import plan_blocks
from gecoz_tpu.tools.driver import (DECODE_CHUNK, _COMPLEMENT, _gff_row,
                                    _resume_prefix, _run_tasks)
from gecoz_tpu.utils import metrics
from gecoz_tpu.utils.hostmem import warm_for_block
from gecoz_tpu_torch.formats.gcz import GecozWriter
from gecoz_tpu_torch.ops import fmq
from gecoz_tpu_torch.tools.batch_search import find_batched
from gecoz_tpu_torch.utils.device import device as pick_device
from gecoz_tpu_torch.utils.device import sync

log = logging.getLogger("gecoz")


def index_fasta(ipath, opath, xpath=None, sampling=DEFAULT_SAMPLING_RATE,
                resume: bool = False,
                device: torch.device | str | None = None) -> None:
    """FASTA -> .gcz/.gcx, encoding every block on `device` (default: the
    card).  With resume=True, complete leading blocks of an existing output
    pair that match the plan are kept and encoding restarts after them."""
    t0 = time.time()
    ipath = Path(ipath)
    sequences = list(iter_fasta(ipath, lazy=True))
    if not sequences:
        raise SystemExit(f"no data found in file: {ipath}")
    blocks = plan_blocks(sequences)
    warm_for_block(max(sum(s.length + 1 for s in b.sequences)
                       for b in blocks))
    log.info("indexing %d sequences in %d blocks", len(sequences), len(blocks))
    skip = _resume_prefix(opath, xpath, blocks, sampling) if resume else 0
    if skip:
        log.info("resuming after %d complete blocks", skip)
        blocks = blocks[skip:]
    with GecozWriter(opath, xpath, sampling, device=device,
                     append=skip > 0) as w:
        for block in blocks:
            with metrics.phase("index.read_fasta"):
                parts = []
                for seq in block.sequences:
                    parts.append(read_sequence(ipath, seq))
                    parts.append(np.zeros(1, dtype=np.uint8))
                data = np.concatenate(parts)
            with metrics.phase("index.encode_block", len(data)):
                w.write(block.headers, data)
    log.info("finished in %d ms", (time.time() - t0) * 1000)


def decompress(ipath, opath, threads: int = 1,
               device: torch.device | str | None = None) -> None:
    """.gcz -> FASTA (GecoRead.fasta:83-175), every block decoded on
    `device` (default: the card).

    The output file is pre-sized from the exact per-record layout; each
    block's text is decoded whole on the card, fetched, and reflowed into
    its region in DECODE_CHUNK pieces by `threads` host workers."""
    t0 = time.time()
    dev = pick_device(device)
    reader = GecozReader(ipath)
    if reader.headers:
        warm_for_block(max(h.len for h in reader.headers))
    with open(opath, "wb"):
        pass                                  # create/truncate
    base = 0
    for bheader in reader.headers:
        with metrics.phase("decode.read_block"):
            fm = reader.read(bheader)
        with metrics.phase("decode.extract", bheader.len):
            base = _decompress_block(fm, bheader.headers, opath, base,
                                     threads, dev)
        del fm
    log.info("finished in %d ms", (time.time() - t0) * 1000)


def _decompress_block(fm, headers: list[str], opath, base: int,
                      threads: int, dev: torch.device) -> int:
    """Decode one block into its pre-sized region of `opath`; returns the
    file offset following the block's records."""
    import bisect

    # record layout: (file_off, header_len, header_bytes, lo, hi) per seq
    recs = []
    off = base
    for i, hdr in enumerate(headers):
        b, t = fm.seq_bounds(i)
        hbytes = b">" + hdr.encode() + b"\n"
        recs.append((off, len(hbytes), hbytes, b, t))
        off += record_size(hdr, t - b)
    end = off
    with open(opath, "r+b") as f:
        f.truncate(end)
    mm = np.memmap(opath, dtype=np.uint8, mode="r+")
    for roff, hlen, hbytes, _, _ in recs:
        mm[roff:roff + hlen] = np.frombuffer(hbytes, np.uint8)
    starts = [r[3] for r in recs]             # sequence lo bounds, ascending

    def scatter(lo: int, data: np.ndarray) -> None:
        """Route global text chunk [lo, lo+len) to its record segments."""
        hi = lo + len(data)
        i = max(0, bisect.bisect_right(starts, lo) - 1)
        while i < len(recs) and recs[i][3] < hi:
            roff, hlen, _, b, t = recs[i]
            s0, s1 = max(lo, b), min(hi, t)
            if s1 > s0:
                write_fasta_segment(mm, roff, hlen, t - b, s0 - b, s1 - b,
                                    data[s0 - lo:s1 - lo])
            i += 1

    text = _device_decode(fm, dev)
    with metrics.phase("decode.reflow", fm.length):
        chunks = [(lo, text[lo:lo + DECODE_CHUNK])
                  for lo in range(0, fm.length, DECODE_CHUNK)]
        _run_tasks([(scatter, c) for c in chunks], threads)
        mm.flush()
    return end


def _device_decode(fm, dev: torch.device) -> np.ndarray:
    """Full-text decode of one block on `dev`, phase by phase: the host
    decodes the BWT out of the wavelet tree, the BWT and the two .gcx
    arrays go up, the query state and LF tables are built there, the LF
    walks (kernel K2) decode, and the text comes back."""
    fm._require_index()                       # SystemExit: no .gcx
    n = fm.length
    with metrics.phase("decode.host_bwt", n):
        _ = fm.bwt
    with metrics.phase("decode.lift", n):
        block = fmq.device_block_from_fm(fm, dev)
        sync(dev)
    with metrics.phase("decode.tables", n):
        block = fmq.with_lf_table(block)
        sync(dev)
    with metrics.phase("decode.walk", n):
        text = fmq.decode_text(block)
        del block
        sync(dev)
    with metrics.phase("decode.fetch", n):
        return text.cpu().numpy()


def gff_search(ref_path, fasta_path, out=None,
               device: torch.device | str | None = None) -> None:
    """Query-FASTA search emitting GFF3 rows, forward + reverse complement
    (SimpleGFFGenerator.search:45-163): all queries x strands run as one
    batched search and one batched locate per block on `device` (default:
    the card)."""
    out = sys.stdout if out is None else out
    dev = pick_device(device)
    reader = GecozReader(ref_path)

    queries = []
    for q in iter_fasta(fasta_path):
        seq = bytes(q.data).replace(b"U", b"T")
        rev = seq[::-1].translate(_COMPLEMENT)
        queries.append((q.header, seq, rev))

    # one block's query state at a time (GecoMatch.java:109-135)
    patterns = [s for _, f, r in queries for s in (f, r)]
    results = []              # per block: (seq headers, {strand_idx: hits})
    for bheader in reader.headers:
        fm = reader.read(bheader)
        results.append((bheader.headers, find_batched(fm, patterns, dev)))
        del fm

    # emit in the reference's row order: query -> strand -> block -> seq
    for qi, (header, fwd, _) in enumerate(queries):
        for si, reverse in ((2 * qi, False), (2 * qi + 1, True)):
            for seq_headers, per in results:
                for i, hits in sorted(per[si].items()):
                    for p in hits:
                        _gff_row(out, seq_headers[i], int(p), len(fwd),
                                 reverse, header)
