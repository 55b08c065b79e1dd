# Frozen copy of multiz_tpu_torch/seqio.py at commit 1de2067, kept by the benchmark
# (mzbench/) so that its inputs and its reference never import the program.
# Changes: the native runtime is never loaded (numpy only); cut to what
# the benchmark's sequential tba and inputs call.
"""Sequence file I/O: multi-contig FASTA (and UCSC .nib) readers.

Replaces the reference seq layer (seq.c:139-495, nib.c:14-39) with
vectorized NumPy readers. Header metadata follows parseHeader
(multi_util.c:311-322): ``>name:chr:start-end:strand:size`` or
``>name:chr:start:strand:size``; otherwise the filename-based fallback of
parseMSAHeader (multi_util.c:300-305).
"""

from __future__ import annotations

import os
import re
import struct
from dataclasses import dataclass
from typing import Iterator, List, Tuple

import numpy as np


@dataclass
class Contig:
    header: str  # full '>' line (without newline)
    seq: np.ndarray  # uint8


@dataclass
class ContigMeta:
    name: str
    contig: str
    start: int  # 1-based inclusive
    end: int  # inclusive
    strand: str
    size: int


_H6 = re.compile(r"^>([^:]+):([^:]+):(\d+)-(\d+):(.):(\d+)")
_H5 = re.compile(r"^>([^:]+):([^:]+):(\d+):(.):(\d+)")


def _atoi(s: str) -> int:
    """C atoi: optional sign + leading digits, 0 otherwise."""
    m = re.match(r"\s*([+-]?\d+)", s)
    return int(m.group(1)) if m else 0


def parse_header(fn: str, contig: Contig) -> ContigMeta:
    """parseHeader (multi_util.c:311-322) + filename fallback."""
    h = contig.header
    m = _H6.match(h)
    if m:
        return ContigMeta(
            m.group(1), m.group(2), int(m.group(3)), int(m.group(4)),
            m.group(5), int(m.group(6)),
        )
    m = _H5.match(h)
    if m:
        start = int(m.group(3))
        return ContigMeta(
            m.group(1), m.group(2), start,
            start + int(contig.seq.shape[0]) - 1, m.group(4), int(m.group(5)),
        )
    # 17-field ENCODE/MSA headers (multi_util.c:261-299) then plain
    # fallback; the C requires EXACTLY 17 '|' separators (i == 17,
    # multi_util.c:277) and uses atoi (leading digits, else 0)
    fields = h[1:].split("|")
    if len(fields) == 18:
        a = fields
        if all(a[i] != "." for i in (0, 7, 8, 9, 10, 11)):
            start = _atoi(a[8])
            return ContigMeta(
                a[0], a[7], start, start + int(contig.seq.shape[0]) - 1,
                a[11][0], _atoi(a[10]),
            )
        if all(a[i] != "." for i in (0, 15, 13, 11)):
            end = _atoi(a[13])
            return ContigMeta(a[0], a[15], 1, end, a[11][0], end)
    n = int(contig.seq.shape[0])
    base = fn
    return ContigMeta(base, base, 1, n, "+", n)


def read_fasta(path: str) -> List[Contig]:
    with open(path, "rb") as fh:
        data = fh.read()
    out: List[Contig] = []
    pos = 0
    if not data.lstrip().startswith(b">"):
        raise ValueError(f"{path}: not a FASTA file")
    chunks = data.split(b"\n>")
    for i, ch in enumerate(chunks):
        if i == 0:
            ch = ch.lstrip()
            if not ch.startswith(b">"):
                continue
            ch = ch[1:]
        nl = ch.find(b"\n")
        if nl < 0:
            header, body = ch, b""
        else:
            header, body = ch[:nl], ch[nl + 1 :]
        seq = np.frombuffer(
            body.replace(b"\n", b"").replace(b"\r", b""), dtype=np.uint8
        ).copy()
        out.append(Contig(">" + header.decode("latin-1"), seq))
    return out


# --------------------------------------------------------------------------
# Filename spec syntax "seqfile{maskfile}[from,to]-" (seq.c:282-324)
# --------------------------------------------------------------------------

# dna_complement (seq.c:75-79): IUPAC map, everything unmapped -> ' '
_DNA_COMPL = np.frombuffer(
    (
        " " * 64
        + " TVGH  CD  M KN   YSA BWXR      "
        + " tvgh  cd  m kn   ysa bwxr      "
        + " " * 128
    ).encode("latin-1"),
    dtype=np.uint8,
).copy()


@dataclass
class FnameSpec:
    """Parsed ``seqfile{maskfile}[from,to]-`` (parse_fname,
    seq.c:282-324). ``from_``/``to`` are 1-based inclusive; ``to`` is
    None without a subrange."""

    fname: str
    from_: int = 1
    to: int | None = None
    maskname: str = ""
    revcomp: bool = False


def parse_fname(arg: str) -> FnameSpec:
    spec = FnameSpec(fname=arg)
    if spec.fname.endswith("-"):
        spec.fname = spec.fname[:-1]
        spec.revcomp = True
    i = spec.fname.find("[")
    if i >= 0:
        m = re.match(r"\[(\d+),(\d+)\]", spec.fname[i:])
        if not m:
            raise ValueError(f"improper positions specification: {arg}")
        spec.from_, spec.to = int(m.group(1)), int(m.group(2))
        if spec.from_ <= 0 or spec.from_ > spec.to:
            raise ValueError(f"improper positions specification: {arg}")
        spec.fname = spec.fname[:i]
    j = spec.fname.find("{")
    if j >= 0:
        k = spec.fname.find("}", j + 1)
        if k >= 0:
            spec.maskname = spec.fname[j + 1 : k]
            spec.fname = spec.fname[:j]
    return spec


def read_fasta_spec(arg: str) -> List[Contig]:
    """Open a sequence file by spec string with the reference's
    semantics: a ``[from,to]`` subrange applies to the FIRST contig only
    and stops reading after it (seq_read_fasta, seq.c:147-155,221-231);
    a trailing ``-`` reverse-complements every contig read
    (seq.c:234-237). The ``{maskfile}`` component is parsed but NOT
    applied — the reference checks SEQ_HAS_MASK, which nothing sets
    before the first read, so masking is inert in this version
    (seq.c:238-240 vs seq.c:257); we parse and preserve the name only.

    Works for FASTA and .nib files (seq_read_nib honors from/len,
    seq.c:459-476)."""
    spec = parse_fname(arg)
    with open(spec.fname, "rb") as fh:
        magic = fh.read(4)
    is_nib = len(magic) == 4 and struct.unpack("<I", magic)[0] == NIB_MAGIC
    if is_nib:
        seq = read_nib(spec.fname)
        contigs = [Contig(">" + os.path.basename(spec.fname), seq)]
    else:
        contigs = read_fasta(spec.fname)
    if spec.to is not None:
        first = contigs[0]
        n = int(first.seq.shape[0])
        if spec.from_ < 1 or spec.to > n or spec.to < spec.from_:
            raise ValueError(
                f"range [{spec.from_},{spec.to}] incommensurate with "
                f"sequence [1,{n}]"
            )
        contigs = [
            Contig(first.header, first.seq[spec.from_ - 1 : spec.to].copy())
        ]
    if spec.revcomp:
        contigs = [
            Contig(c.header, _DNA_COMPL[c.seq[::-1]].copy())
            for c in contigs
        ]
    return contigs


# --------------------------------------------------------------------------
# UCSC .nib: 2 bases/byte; T/C/A/G/N = 0-4, high bit = repeat-masked
# (nib.c:14-39)
# --------------------------------------------------------------------------

NIB_MAGIC = 0x6BE93D3A
_NIB_CHARS = np.frombuffer(b"TCAGN---", dtype=np.uint8)
_NIB_LOWER = np.frombuffer(b"tcagn---", dtype=np.uint8)


def read_nib(path: str) -> np.ndarray:
    with open(path, "rb") as fh:
        magic, length = struct.unpack("<II", fh.read(8))
        if magic != NIB_MAGIC:
            magic, length = struct.unpack(">II", struct.pack("<II", magic, length))
            if magic != NIB_MAGIC:
                raise ValueError(f"{path}: bad nib signature")
        raw = np.frombuffer(fh.read((length + 1) // 2), dtype=np.uint8)
    hi = raw >> 4
    lo = raw & 0x0F
    codes = np.empty(raw.shape[0] * 2, dtype=np.uint8)
    codes[0::2] = hi
    codes[1::2] = lo
    codes = codes[:length]
    masked = (codes & 0x8) != 0
    base = codes & 0x7
    out = np.where(masked, _NIB_LOWER[base], _NIB_CHARS[base])
    return out.astype(np.uint8)

