"""FASTA reading and FASTA->MAPLE conversion.

Reference semantics: core/io.{h,cpp} read_fasta and core/sequence_utils.{h,cpp}
consensus deduction / delta extraction — ambiguous letters other than a single
real base become missations; tips without parseable dates are dropped with a
warning (core/cmdline.cpp fasta_to_maple path)."""

from __future__ import annotations

import gzip
from dataclasses import dataclass, field

import numpy as np

from .. import seq as seqm
from ..dates import extract_date_range_from_id


@dataclass
class FastaRecord:
    id: str
    bits: np.ndarray  # 4-bit ambiguity masks


@dataclass
class TipData:
    name: str
    t_min: float
    t_max: float
    deltas: list = field(default_factory=list)        # [(site, to_state)]
    miss_intervals: list = field(default_factory=list)  # [(start, end)]


def _open(path):
    if str(path).endswith(".gz"):
        return gzip.open(path, "rt")
    return open(path, "r")


def read_fasta(path) -> list[FastaRecord]:
    records = []
    cur_id, chunks = None, []
    with _open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            if line.startswith(">"):
                if cur_id is not None:
                    records.append(FastaRecord(cur_id, seqm.str_to_bits("".join(chunks))))
                cur_id, chunks = line[1:].strip(), []
            else:
                chunks.append(line)
        if cur_id is not None:
            records.append(FastaRecord(cur_id, seqm.str_to_bits("".join(chunks))))
    return records


def deduce_consensus(records: list[FastaRecord], length: int) -> np.ndarray:
    """Most common unambiguous base per site (ties -> lowest letter index),
    defaulting to A where nothing real is seen (cf. deduce_consensus_sequence,
    core/sequence_utils.h:40-60)."""
    counts = np.zeros((4, length), dtype=np.int64)
    for r in records:
        real = seqm.bits_to_real(r.bits[:length])
        ok = real >= 0
        idx = np.nonzero(ok)[0]
        np.add.at(counts, (real[idx], idx), 1)
    return np.argmax(counts, axis=0).astype(np.int8)


def _runs_of_true(mask: np.ndarray):
    """[(start, end)) intervals of consecutive True."""
    if not mask.any():
        return []
    diff = np.diff(mask.astype(np.int8))
    starts = list(np.nonzero(diff == 1)[0] + 1)
    ends = list(np.nonzero(diff == -1)[0] + 1)
    if mask[0]:
        starts = [0] + starts
    if mask[-1]:
        ends = ends + [len(mask)]
    return list(zip(starts, ends))


def fasta_to_tips(records: list[FastaRecord], ref_seq: np.ndarray,
                  warn=lambda msg: None) -> list[TipData]:
    """Extract per-tip deltas and missing intervals vs a reference sequence
    (cf. calculate_delta_from_reference, core/sequence_utils.h:62-96)."""
    L = len(ref_seq)
    tips = []
    for r in records:
        dr = extract_date_range_from_id(r.id)
        if dr is None:
            warn(f"tip {r.id!r}: no parseable date at end of id; dropped")
            continue
        bits = r.bits
        if len(bits) != L:
            if len(bits) < L:
                bits = np.concatenate([bits, np.zeros(L - len(bits), dtype=bits.dtype)])
            else:
                bits = bits[:L]
        if (bits == 0).any():
            warn(f"tip {r.id!r}: invalid characters treated as N")
            bits = np.where(bits == 0, 15, bits)
        real = seqm.bits_to_real(bits)
        missing = real < 0  # any ambiguity -> missing (ambiguity info dropped with warning)
        deltas = [(int(l), int(real[l]))
                  for l in np.nonzero((~missing) & (real != ref_seq))[0]]
        tips.append(TipData(name=r.id, t_min=dr[0], t_max=dr[1], deltas=deltas,
                            miss_intervals=_runs_of_true(missing)))
    return tips


def write_resolved_fasta(tree, f):
    """Write every tip's fully resolved sequence (missing sites inherit the
    state just above their missation, exactly view_of_sequence_at semantics)
    as FASTA with `name|iso_date` headers (io.cpp:274-287
    output_resolved_fasta)."""
    from ..dates import to_iso_date
    from ..seq import REAL_TO_CHAR

    close = False
    if isinstance(f, (str, bytes)):
        f = open(f, "w")
        close = True
    try:
        for i in range(tree.num_tips):
            name = tree.name[i] if tree.name and tree.name[i] else f"tip{i}"
            f.write(f">{name}|{to_iso_date(float(tree.t[i]))}\n")
            f.write("".join(REAL_TO_CHAR[tree.sequence_at(i)]))
            f.write("\n")
    finally:
        if close:
            f.close()
