"""graftlint baseline: committed debt ledger so CI gates on *new* findings.

Entries are ``Finding.key()`` strings (rule | posix path | stripped line
text) with an occurrence count — text-based identity survives unrelated
line-number drift, the same trade ruff/clang-tidy baselines make. The
intended lifecycle: the baseline only shrinks. ``--update-baseline``
rewrites it from the current findings; ``--strict-baseline`` (the CI
mode) fails on *stale* entries too, so fixing a violation forces the
ledger entry out in the same commit.
"""

from __future__ import annotations

import collections
import json
from pathlib import Path

BASELINE_VERSION = 1
_BASELINE_NAME = "graftlint.baseline.json"


def default_baseline_path():
    """The port's own ledger, ``deeplearning4j_tpu_torch/analysis/
    graftlint.baseline.json``, beside this module: never the JAX
    package's ``<repo>/graftlint.baseline.json``."""
    return Path(__file__).resolve().parent / _BASELINE_NAME


def load_baseline(path):
    """{key: count}; an absent file is an empty baseline."""
    p = Path(path)
    if not p.exists():
        return {}
    doc = json.loads(p.read_text(encoding="utf-8"))
    if doc.get("version") != BASELINE_VERSION:
        raise ValueError(f"unsupported baseline version in {p}: "
                         f"{doc.get('version')!r}")
    return {str(k): int(v) for k, v in doc.get("entries", {}).items()}


def save_baseline(path, findings):
    """Write the findings as the new baseline (sorted keys: stable diffs)."""
    counts = collections.Counter(f.key() for f in findings)
    doc = {"version": BASELINE_VERSION,
           "note": ("pre-existing graftlint findings; this ledger only "
                    "shrinks — fix the finding and drop the entry "
                    "(or run lint --update-baseline)"),
           "entries": {k: counts[k] for k in sorted(counts)}}
    Path(path).write_text(json.dumps(doc, indent=1) + "\n",
                          encoding="utf-8")
    return doc


def apply_baseline(findings, baseline):
    """Split findings against the ledger.

    Returns ``(new, known, stale)``: findings not covered by the baseline,
    findings absorbed by it, and the dict of baseline entries whose
    current occurrence count dropped below the recorded one (fixed debt
    that should leave the ledger)."""
    budget = dict(baseline)
    new, known = [], []
    for f in findings:
        k = f.key()
        if budget.get(k, 0) > 0:
            budget[k] -= 1
            known.append(f)
        else:
            new.append(f)
    stale = {k: v for k, v in budget.items() if v > 0}
    return new, known, stale
