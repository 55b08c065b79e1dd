"""Answers kept per (cell, seed) in ``mzbench/.cache/`` inside the
checkout, so that a seed's second run does not work its reference out
again. A key also covers the cell's configuration and traffic mix, so an
edited file never meets an old answer. Files are written whole under a
temporary name and then renamed, so a run that is cut leaves none half
written."""

from __future__ import annotations

import gzip
import hashlib
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))
DIR = os.path.join(HERE, ".cache")


def path(ctx, what: str) -> str:
    key = hashlib.sha256(json.dumps([ctx.config, ctx.mix], sort_keys=True)
                         .encode()).hexdigest()[:16]
    return os.path.join(DIR, ctx.cell["name"], f"{ctx.seed}-{key}.{what}")


def text(p: str, make) -> tuple:
    """(the text at ``p``, True) if it is there, else (``make()``, False)
    with the text written to ``p``, gzip-compressed."""
    if os.path.exists(p):
        with gzip.open(p, "rt") as fh:
            return fh.read(), True
    t = make()
    os.makedirs(os.path.dirname(p), exist_ok=True)
    tmp = f"{p}.part{os.getpid()}"
    with gzip.open(tmp, "wt", compresslevel=1) as fh:
        fh.write(t)
    os.replace(tmp, p)
    return t, False
