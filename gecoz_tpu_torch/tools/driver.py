"""Drivers: FASTA -> .gcz/.gcx, .gcz -> FASTA, GFF3 search, host verbs.

Port of gecoz_tpu/tools/driver.py.  Each card verb takes the reference's
`backend` (`utils/device.py::resolve_backend`):

* "auto" and "device": the device tier on `device` (default: the card),
  with no host fallback: a failure on the card raises.  `index_fasta`
  (26-113) goes through the reference's device route,
  `_index_blocks_mesh` (116-173) into `parallel/mesh.py::encode_blocks`
  in bounded windows of blocks; `decompress` (223-365) is the reference's
  `--backend device` route; `gff_search` (421-466) its device branch.
* "numpy" and "native": the reference's host tier, through the port's
  copies: `encode_block_host` per block on a pool of `threads` workers
  with a bounded pending queue (87-112), the host FM-index's chunked walk
  decode on `threads` workers (299-313), and `FMIndex.find` per query and
  strand (449-457).  Nothing runs on a device.

The host verbs, which the JAX package also runs on the host whatever its
backend (driver.py:368-415, 489-511), are the port's copies of the
reference's code: `extract_range`, `match` and `check` on the host
FM-index (`FMIndex.find`/`extract`), with the `--resume` scan, the task
runner and the GFF3 row writer they share with the card's verbs.
"""

from __future__ import annotations

import logging
import numbers
import sys
import time
from pathlib import Path

import numpy as np
import torch

from gecoz_tpu_torch.formats.fasta import (iter_fasta, read_queries,
                                           read_sequence, record_size,
                                           write_fasta_segment)
from gecoz_tpu_torch.formats.gcz import (DEFAULT_SAMPLING_RATE, GecozReader,
                                         GecozWriter, encode_block_host)
from gecoz_tpu_torch.ops import fmq, lfwalk
from gecoz_tpu_torch.tools.batch_search import (BlockHits, PatternBatch,
                                                find_batched)
from gecoz_tpu_torch.tools.blocks import plan_blocks
from gecoz_tpu_torch.utils import metrics
from gecoz_tpu_torch.utils.device import device as pick_device
from gecoz_tpu_torch.utils.device import resolve_backend, sync
from gecoz_tpu_torch.utils.hostmem import warm_for_block

log = logging.getLogger("gecoz")


def _resume_prefix(opath, xpath, blocks, sampling) -> int:
    """Count complete leading blocks of an existing output pair matching
    the plan; truncate both files to that prefix.  Returns the count."""
    import os

    from gecoz_tpu_torch.formats.gcz import (RefBlockHeader, SSA_HEADER_LEN,
                                             default_gcx_path, index_size,
                                             parse_ssa_header, header_hash)
    opath = Path(opath)
    gcx_path = Path(xpath) if xpath else default_gcx_path(opath)
    if not opath.is_file() or not gcx_path.is_file():
        return 0
    ref = opath.read_bytes()
    ssa = gcx_path.read_bytes()
    sf = sampling.bit_length() - 1
    pos = xpos = 0
    good = 0
    for block in blocks:
        try:
            h = RefBlockHeader.parse(ref, pos)
        except (ValueError, IndexError):
            break
        expected_len = sum(s.length + 1 for s in block.sequences)
        if h.headers != block.headers or h.len != expected_len \
                or pos + h.size > len(ref):
            break
        xsize = SSA_HEADER_LEN + index_size(h.len, sf)
        if xpos + xsize > len(ssa):
            break
        try:
            blen, hsh = parse_ssa_header(ssa, xpos)
        except ValueError:
            break
        if hsh != header_hash(h.headers) or blen != index_size(h.len, sf):
            break
        pos += h.size
        xpos += xsize
        good += 1
    if good:
        os.truncate(opath, pos)
        os.truncate(gcx_path, xpos)
    return good


DECODE_CHUNK = 4 << 20      # bytes of text per decode task (GecoRead's 4 MiB)
_COMPLEMENT = bytes.maketrans(b"ATCG", b"TAGC")


def _tier(backend: str, dev, threads: int | None = None) -> str:
    """The tier a verb runs on, for the INFO log."""
    if dev is not None:
        return f"backend {backend}: the device tier on {dev}"
    return f"backend {backend}: the host tier" + (
        f", {threads} threads" if threads else "")


def _run_tasks(tasks, threads: int) -> None:
    if threads <= 1 or len(tasks) <= 1:
        for fn, args in tasks:
            fn(*args)
        return
    import concurrent.futures as cf
    with cf.ThreadPoolExecutor(max_workers=threads) as pool:
        futs = [pool.submit(fn, *args) for fn, args in tasks]
        for f in futs:
            f.result()


def check_sampling(rate) -> None:
    """`--sampling`, the suffix array's sampling rate: an integer power of
    2 (1, 2, 4, ...).  Raises ValueError otherwise, which `index_fasta`
    does before it opens or truncates any file (ROADMAP C8)."""
    if not isinstance(rate, numbers.Integral) or rate < 1 \
            or rate & (rate - 1):
        raise ValueError(f"the sampling rate must be a power of 2 (1, 2, 4, "
                         f"..., {DEFAULT_SAMPLING_RATE} by default), got "
                         f"{rate!r}")


@metrics.phase("index")
def index_fasta(ipath, opath, xpath=None, sampling=DEFAULT_SAMPLING_RATE,
                backend: str = "auto", threads: int = 1,
                resume: bool = False,
                device: torch.device | str | None = None,
                mesh=None) -> None:
    """FASTA -> .gcz/.gcx (GecoIndex.index).

    On the device tier every block is encoded on `device` (default: the
    card) through `_index_blocks_mesh`; a block beyond one card is sorted
    sharded over `mesh` (default: every local card) when it has more than
    one shard.  On the host tier ("numpy", "native") each block goes
    through `encode_block_host`; with threads > 1, blocks encode
    concurrently in a bounded pool (the C++ SA-IS and numpy serializers
    release the GIL), written in plan order with in-flight work capped
    like the reference's 1-deep queue (GecozFileWriter.java:174-201).
    With resume=True, complete leading blocks of an existing output pair
    that match the plan are kept and encoding restarts after them.  A
    sampling rate that is not a power of 2 is refused before any file
    opens."""
    check_sampling(sampling)
    t0 = time.time()
    tier = resolve_backend(backend)
    dev = pick_device(device) if tier == "device" else None
    ipath = Path(ipath)
    with metrics.phase("index.plan"):
        sequences = list(iter_fasta(ipath, lazy=True))
        if not sequences:
            raise SystemExit(f"no data found in file: {ipath}")
        with metrics.phase("index.plan_blocks"):
            blocks = plan_blocks(sequences)
        warm_for_block(max(sum(s.length + 1 for s in b.sequences)
                           for b in blocks))
    log.info("indexing %d sequences in %d blocks (%s)", len(sequences),
             len(blocks), _tier(backend, dev, threads))
    skip = _resume_prefix(opath, xpath, blocks, sampling) if resume else 0
    if skip:
        log.info("resuming after %d complete blocks", skip)
        blocks = blocks[skip:]

    def read_block(block):
        parts = []
        with metrics.phase("index.read_fasta"):
            for seq in block.sequences:
                parts.append(read_sequence(ipath, seq))
                parts.append(np.zeros(1, dtype=np.uint8))
            return np.concatenate(parts)

    with GecozWriter(opath, xpath, append=skip > 0) as w:
        if dev is not None:
            _index_blocks_mesh(blocks, read_block, w, sampling, dev, mesh)
        else:
            _index_blocks_host(blocks, read_block, w, sampling, tier,
                               threads)
    log.info("finished in %d ms", (time.time() - t0) * 1000)


def _index_blocks_host(blocks, read_block, w, sampling, backend,
                       threads) -> None:
    """The host tier: `encode_block_host` per block, in plan order, on a
    pool of `threads` workers with at most threads + 1 blocks pending
    (gecoz_tpu/tools/driver.py:87-112)."""
    if threads <= 1:
        for block in blocks:
            data = read_block(block)
            with metrics.phase("index.encode_block", len(data)):
                w.write_encoded(*encode_block_host(data, block.headers,
                                                   sampling, backend))
        return
    import concurrent.futures as cf
    pool = cf.ThreadPoolExecutor(max_workers=threads)
    pending = []
    try:
        for block in blocks:
            data = read_block(block)
            pending.append(pool.submit(encode_block_host, data,
                                       block.headers, sampling, backend))
            while len(pending) > threads + 1:
                w.write_encoded(*pending.pop(0).result())
        for fut in pending:
            w.write_encoded(*fut.result())
    finally:
        pool.shutdown()


MESH_WINDOW_BYTES = 256 << 20   # text bytes batched per mesh-encode window
MESH_WINDOW_BLOCKS = 16


def _index_blocks_mesh(blocks, read_block, w, sampling, device,
                       mesh=None) -> None:
    """Encode plan blocks through `parallel/mesh.py::encode_blocks` in
    bounded windows (at most MESH_WINDOW_BLOCKS blocks, closed once they
    hold MESH_WINDOW_BYTES), so peak host memory is O(window), not
    O(file)."""
    from gecoz_tpu_torch.parallel.mesh import encode_blocks

    window: list[np.ndarray] = []
    hdrs: list[list[str]] = []

    def flush() -> None:
        if not window:
            return
        with metrics.phase("index.encode_mesh", sum(len(d) for d in window)):
            encoded = encode_blocks(window, hdrs, sampling, device, mesh)
        with metrics.phase("index.write"):
            for gcz, gcx in encoded:
                w.write_encoded(gcz, gcx)
        window.clear()
        hdrs.clear()

    acc = 0
    for block in blocks:
        data = read_block(block)
        window.append(data)
        hdrs.append(block.headers)
        acc += len(data)
        if acc >= MESH_WINDOW_BYTES or len(window) >= MESH_WINDOW_BLOCKS:
            flush()
            acc = 0
    flush()


@metrics.phase("decode")
def decompress(ipath, opath, backend: str = "auto", threads: int = 1,
               device: torch.device | str | None = None) -> None:
    """.gcz -> FASTA (GecoRead.fasta:83-175).

    The output file is pre-sized from the exact per-record layout.  On the
    device tier each block's text is decoded whole on `device` (default:
    the card), fetched, and reflowed into its region in DECODE_CHUNK
    pieces by `threads` host workers; on the host tier ("numpy",
    "native") `threads` workers decode DECODE_CHUNK pieces over the host
    FM-index's shared LF table and write them in place."""
    t0 = time.time()
    tier = resolve_backend(backend)
    dev = pick_device(device) if tier == "device" else None
    log.info("decompressing (%s)", _tier(backend, dev, threads))
    if dev is not None and dev.type == "cuda":
        # build (first use) and load the walk kernels in a phase of their
        # own, not in the first block's decode.walk
        with metrics.phase("decode.kernels"):
            lfwalk._lib()
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
                      threads: int, dev: torch.device | None) -> int:
    """Decode one block into its pre-sized region of `opath`, on `dev`, or
    on the host tier when `dev` is None; returns the file offset following
    the block's records."""
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

    if dev is not None:
        text = _device_decode(fm, dev)
        with metrics.phase("decode.reflow", fm.length):
            chunks = [(lo, text[lo:lo + DECODE_CHUNK])
                      for lo in range(0, fm.length, DECODE_CHUNK)]
            _run_tasks([(scatter, c) for c in chunks], threads)
            mm.flush()
        return end

    # host tier: chunked walk decode over the shared read-only LF table
    fm._require_index()
    rate = 1 << fm.index.sampling_factor
    _ = fm.bwt, fm.lf, fm.walk_seeds()        # materialize shared state once
    nwalks = fm.n_walks
    wpc = max(1, DECODE_CHUNK // rate)        # walks per chunk

    def decode_task(w0: int, w1: int) -> None:
        scatter(w0 * rate, fm.decode_walks(w0, w1))

    tasks = [(decode_task, (w0, min(w0 + wpc, nwalks)))
             for w0 in range(0, nwalks, wpc)]
    _run_tasks(tasks, threads)
    mm.flush()
    return end


def _device_decode(fm, dev: torch.device) -> np.ndarray:
    """Full-text decode of one block on `dev`, phase by phase: the host
    takes the wavelet tree's stored streams and node table
    (`HSWT.stored_streams`), they and the .gcx's bytes go up and are
    decoded there (the BWT, the sampled rows and values), the query state
    (no bit planes: the walks read none) and LF tables are built there,
    the LF walks (kernel K2) decode, and the text comes back.  Any
    alphabet: past 16 symbols the walks read byte rows (k = 4)."""
    fm._require_index()                       # SystemExit: no .gcx
    n = fm.length
    with metrics.phase("decode.host_bwt", n):
        fm.hswt.stored_streams()
    with metrics.phase("decode.lift", n):
        block = fmq.device_block_from_fm(fm, dev, planes=False)
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


@metrics.phase("search")
def gff_search(ref_path, fasta_path, out=None, backend: str = "auto",
               device: torch.device | str | None = None) -> None:
    """Query-FASTA search emitting GFF3 rows, forward + reverse complement
    (SimpleGFFGenerator.search:45-163).  On the device tier all queries x
    strands are packed and uploaded once, and run as one batched search
    and one batched locate per block on `device` (default: the card),
    which returns only the patterns that hit; on the host tier ("numpy",
    "native") `FMIndex.find` runs per query and strand.  An empty query
    record gives no row on either tier (ROADMAP C7)."""
    out = sys.stdout if out is None else out
    tier = resolve_backend(backend)
    dev = pick_device(device) if tier == "device" else None
    log.info("GFF3 search (%s)", _tier(backend, dev))
    reader = GecozReader(ref_path)

    with metrics.phase("search.read_queries"):
        headers, seqs, bulk = read_queries(fasta_path)
        metrics.count("search.query_records", len(headers))
        metrics.count("search.query_records_bulk",
                      len(headers) if bulk else 0)
        fwd, rev = _strands(seqs)
        patterns = [b""] * (2 * len(fwd))
        patterns[0::2], patterns[1::2] = fwd, rev
    if dev is not None:
        patterns = PatternBatch(patterns, dev)

    # one block's query state at a time (GecoMatch.java:109-135)
    results = []              # per block: (seq headers, BlockHits)
    for bheader in reader.headers:
        with metrics.phase("search.block"):
            with metrics.phase("search.read_block"):
                fm = reader.read(bheader)
            if dev is not None:
                per = find_batched(fm, patterns, dev)
            else:
                per = [fm.find(p) for p in patterns]
            del fm
        hits = per if isinstance(per, BlockHits) else BlockHits.of(
            per, len(patterns))
        metrics.count("search.blocks")
        metrics.count("search.blocks_hit", int(len(hits.pattern) > 0))
        results.append((bheader.headers, hits))

    # emit in the reference's row order: query -> strand -> block -> seq
    # -> position (each block's hits are in pattern, record, position order)
    with metrics.phase("search.rows"):
        _write_rows(out, headers, [len(f) for f in fwd], results)


def _write_rows(out, headers, lengths, results, chunk: int = 1 << 16):
    """The GFF3 rows of every block's hits, `chunk` rows a write."""
    if not results:
        return
    pattern = np.concatenate([h.pattern for _, h in results])
    block = np.repeat(np.arange(len(results)),
                      [len(h.pattern) for _, h in results])
    record = np.concatenate([h.record for _, h in results])
    position = np.concatenate([h.position for _, h in results])
    order = np.argsort(pattern, kind="stable")
    targets = [seq_headers for seq_headers, _ in results]
    for at in range(0, len(order), chunk):
        part = order[at:at + chunk]
        out.write("".join(
            _gff_line(targets[b][r], x, lengths[p >> 1], p & 1,
                      headers[p >> 1])
            for p, b, r, x in zip(pattern[part].tolist(), block[part].tolist(),
                                  record[part].tolist(),
                                  position[part].tolist())))


def _strands(seqs: list[bytes]) -> tuple[list[bytes], list[bytes]]:
    """Each sequence with U read as T, and its reverse complement: done
    once over the sequences joined by newlines, which none holds."""
    if not seqs:
        return [], []
    joined = b"\n".join(seqs)
    if b"U" in joined:
        joined = joined.replace(b"U", b"T")
        seqs = joined.split(b"\n")
    rev = joined[::-1].translate(_COMPLEMENT).split(b"\n")
    rev.reverse()
    return seqs, rev


def _gff_row(out, target, pos, plen, reverse, qheader):
    out.write(_gff_line(target, pos, plen, reverse, qheader))


def _gff_line(target, pos, plen, reverse, qheader) -> str:
    strand = "-" if reverse else "+"
    parts = qheader.split("|")
    attrs = f"ID={parts[0]}" if parts else ""
    for extra in parts[1:]:
        attrs += f";Note={extra}"
    return (f"{target}\tgecotools\tdna\t{pos + 1}\t{pos + plen}\t1.000\t"
            f"{strand}\t.\t{attrs}\n")


def extract_range(ipath, header: str, start: int, end: int | None,
                  opath) -> None:
    """.gcz -> .seq range extraction (GecoRead.sequence)."""
    reader = GecozReader(ipath)
    bheader = reader.find_block(header)
    if bheader is None:
        raise SystemExit(f"no sequence found: {header}")
    fm = reader.read(bheader)
    nstr = bheader.headers.index(header)
    data = fm.extract(nstr, start, end)
    with open(opath, "wb") as f:
        f.write(data)


def match(ipath, header: str | None, pattern: str, show_positions: bool,
          out=None) -> int:
    """Count/search a pattern (GecoMatch.match)."""
    out = sys.stdout if out is None else out
    reader = GecozReader(ipath)
    total = 0
    blocks = reader.headers
    if header is not None:
        b = reader.find_block(header)
        if b is None:
            raise SystemExit(f"no sequence found: {header}")
        blocks = [b]
    for bheader in blocks:
        fm = reader.read(bheader)
        if not fm.has_index:
            # count-only mode: no .gcx, so hits cannot be split/located
            c = fm.count_total(pattern.encode())
            if c:
                print(f">{'|'.join(bheader.headers)} found : {c} "
                      f"(no .gcx: block total, positions unavailable)",
                      file=out)
                total += c
            continue
        res = fm.find(pattern.encode())
        for i, hits in sorted(res.items()):
            if header is not None and bheader.headers[i] != header:
                continue
            print(f">{bheader.headers[i]} found : {len(hits)}", file=out)
            total += len(hits)
            if show_positions:
                for p in hits:
                    print(int(p), file=out)
    log.info("total found: %d", total)
    return total


def check(ipath, deep: bool = False, out=None) -> bool:
    """Validate a .gcz/.gcx pair: header chain, index sizes and hashes,
    and (deep) a full decode of every block's wavelet tree.

    The formats are self-describing block chains (GecozFileReader.java:
    81-88 scans them the same way), so verification is streaming.
    """
    out = sys.stdout if out is None else out
    try:
        reader = GecozReader(ipath)
    except (ValueError, IndexError) as ex:
        print(f"CORRUPT: {ex}", file=out)
        return False
    ok = True
    for bheader in reader.headers:
        status = "ok"
        try:
            fm = reader.read(bheader)       # validates gcx hash + length
            if not fm.has_index:
                status = "ok (no .gcx)"
            if deep:
                text = fm.decode_text() if fm.has_index else None
                if text is not None:
                    counts = np.bincount(fm.bwt, minlength=256)
                    if not np.array_equal(np.bincount(text, minlength=256),
                                          counts):
                        raise ValueError("decode histogram mismatch")
        except Exception as ex:
            status = f"CORRUPT: {ex}"
            ok = False
        print(f"block [{', '.join(bheader.headers)}] "
              f"len={bheader.len}: {status}", file=out)
    return ok
