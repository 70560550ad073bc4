"""The operations a traffic mix runs, each through the program's driver
(`gecoz_tpu_torch.tools.driver`) on the card's tier, and the judge of what
they wrote.

An operation is made once per run (`prepare`: inputs, and what the
operation reads that another operation writes), warmed once, then run back
to back in the window; `run(i)` returns the work it did, in the unit of
its traffic's rate metric.  After the window its answers are judged
(`judge`) against the plain reference (`gzref`), which reads them only to
judge them: every search's rows, and the files of a sample of compresses
and decompresses drawn from the seed plus the last one.  The others write
over one shared file, as a user's pipeline overwrites its output, so a run
leaves little for the disk to write back.
"""

from __future__ import annotations

import io
import time
from pathlib import Path

import numpy as np

from gzbench import data
from gzref import fasta as ref_fasta
from gzref import gcz as ref_gcz
from gzref import search as ref_search


def _driver():
    from gecoz_tpu_torch.tools import driver
    return driver


KEPT = 3              # operations among the first KEPT_FROM whose files stay
KEPT_FROM = 8


def gcz_order(path: Path) -> list[str]:
    """The record headers of a `.gcz`, in its blocks' order."""
    return [h for b in ref_gcz.block_headers(Path(path).read_bytes())
            for h in b]


class Operation:
    """One kind of operation over one configuration's records."""

    def __init__(self, config: dict, traffic: dict, seed: int, workdir: Path,
                 device):
        self.config = config
        self.traffic = traffic
        self.seed = seed
        self.dir = Path(workdir)
        self.device = device
        self.records = data.records_of(config, seed)
        self.by_header = dict(self.records)
        self.fasta = self.dir / "input.fa"
        self.mb = sum(len(s) for _, s in self.records) / 1e6
        self.kept = {int(i) for i in data.rng_for(seed, "kept").choice(
            KEPT_FROM, KEPT, replace=False)}
        self.began: dict = {}

    def path(self, i, suffix: str) -> Path:
        """The output of operation i: its own file if it is kept, else the
        file every other operation writes over."""
        return self.dir / f"out{i if i in self.kept else ''}{suffix}"

    def judged(self, done: list[int]) -> list[int]:
        """The kept operations that completed, and the last operation if it
        completed: the shared file holds its output."""
        out = [i for i in done if i in self.kept]
        if done and done[-1] not in self.kept:
            out.append(done[-1])
        return out

    def written(self, i, suffix: str) -> bool:
        """Operation i's file is there and was written since it began (the
        shared file may hold an earlier operation's output)."""
        p = self.path(i, suffix)
        return p.is_file() and p.stat().st_mtime >= self.began[i] - 0.01

    def start(self, i) -> None:
        self.began[i] = time.time()

    def prepare(self) -> None:
        data.write_fasta(self.fasta, self.records, self.config["line_width"])

    def compress(self, fasta: Path, gcz: Path) -> None:
        _driver().index_fasta(fasta, gcz, sampling=self.config["sampling"],
                              device=self.device)

    def run(self, i) -> float:
        raise NotImplementedError

    def judge(self, done: list[int], rng: np.random.Generator) -> dict[str, int]:
        raise NotImplementedError


class Compress(Operation):
    """FASTA -> .gcz/.gcx; work: sequence megabytes."""

    def run(self, i) -> float:
        self.start(i)
        self.compress(self.fasta, self.path(i, ".gcz"))
        return self.mb

    def judge(self, done, rng):
        """One judged pair, drawn from the seed, against the reference; the
        other judged pairs against that one, byte for byte."""
        out = dict(outputs_missing=0, outputs_unequal=0)
        pairs = {}
        for i in self.judged(done):
            if self.written(i, ".gcz") and self.written(i, ".gcx"):
                pairs[i] = (self.path(i, ".gcz").read_bytes(),
                            self.path(i, ".gcx").read_bytes())
            else:
                out["outputs_missing"] += 1
        if not pairs:                  # nothing to judge: every record missing
            out["outputs_missing"] += not done
            return out | ref_gcz.judge_pair(b"", b"", self.by_header,
                                            self.config["sampling"],
                                            self.device)
        keys = sorted(pairs)
        chosen = pairs[keys[int(rng.integers(0, len(keys)))]]
        out["outputs_unequal"] = sum(p != chosen for p in pairs.values())
        return out | ref_gcz.judge_pair(*chosen, self.by_header,
                                        self.config["sampling"], self.device)


class Decompress(Operation):
    """.gcz/.gcx (compressed in set-up) -> FASTA; work: sequence megabytes."""

    def prepare(self) -> None:
        super().prepare()
        self.gcz = self.dir / "input.gcz"
        self.compress(self.fasta, self.gcz)

    def run(self, i) -> float:
        self.start(i)
        _driver().decompress(self.gcz, self.path(i, ".fa"), device=self.device)
        return self.mb

    def judge(self, done, rng):
        """Each judged FASTA against the records in the .gcz's order."""
        order = gcz_order(self.gcz)
        want = np.frombuffer(ref_fasta.fasta_bytes(order, self.by_header),
                             np.uint8)
        out = dict(outputs_missing=0, fasta_bytes_wrong=0)
        for i in self.judged(done):
            if not self.written(i, ".fa"):
                out["outputs_missing"] += 1
                continue
            got = np.fromfile(self.path(i, ".fa"), np.uint8)
            out["fasta_bytes_wrong"] += ref_fasta.bytes_wrong(got, want)
        out["outputs_missing"] += not done
        return out


class Search(Operation):
    """GFF3 search of query files against the .gcz compressed in set-up,
    rows to an in-memory sink; work: query records."""

    def prepare(self) -> None:
        super().prepare()
        self.gcz = self.dir / "input.gcz"
        self.compress(self.fasta, self.gcz)
        q = self.traffic["queries"]
        self.queries = {}
        for k in ["warm"] + list(range(self.traffic["files"])):
            self.queries[k] = data.queries_of(
                q, data.rng_for(self.seed, f"queries/{k}"), self.records)
            data.write_queries(self.qpath(k), self.queries[k])
        self.rows: dict = {}

    def qpath(self, k) -> Path:
        return self.dir / f"queries_{k}.fa"

    def file_of(self, i):
        return i if i == "warm" else i % self.traffic["files"]

    def run(self, i) -> float:
        k = self.file_of(i)
        sink = io.StringIO()
        _driver().gff_search(self.gcz, self.qpath(k), out=sink,
                             device=self.device)
        self.rows[i] = sink.getvalue()
        return len(self.queries[k])

    def judge(self, done, rng):
        """Every run's rows against the reference's rows of its file."""
        order = gcz_order(self.gcz)
        files = sorted({self.file_of(i) for i in done})
        want = dict(zip(files, ref_search.expected_rows(
            [self.queries[k] for k in files], order, self.by_header,
            self.device)))
        out = dict(outputs_missing=0, rows_missing=0, rows_extra=0,
                   rows_misplaced=0)
        for i in done:
            if i not in self.rows:
                out["outputs_missing"] += 1
                continue
            faults = ref_search.row_faults(self.rows[i].splitlines(),
                                           want[self.file_of(i)])
            for key, v in faults.items():
                out[key] += v
        out["outputs_missing"] += not done
        return out


OPERATIONS = {"compress": Compress, "decompress": Decompress,
              "search": Search}
