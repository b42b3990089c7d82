"""graftlint reporters: human ``file:line:col`` lines and a JSON document.

The human form is the compiler-error shape editors already parse; the
JSON form is the machine artifact CI and the test-suite read (same
"one schema for every machine-readable artifact" stance as
``telemetry.registry.write_jsonl``).
"""

from __future__ import annotations

import json
import sys


def report_human(new, known, stale, stream=None, verbose=False):
    """Print new findings (always), known/stale summaries (counts), and
    return the one-line verdict string."""
    stream = sys.stderr if stream is None else stream
    for f in new:
        print(f.human(), file=stream)
    if verbose:
        for f in known:
            print(f"{f.human()}  [baselined]", file=stream)
    bits = [f"{len(new)} new finding(s)"]
    if known:
        bits.append(f"{len(known)} baselined")
    if stale:
        bits.append(f"{len(stale)} stale baseline entr"
                    f"{'y' if len(stale) == 1 else 'ies'}")
    verdict = "graftlint: " + ", ".join(bits)
    print(verdict, file=stream)
    if stale:
        for k in sorted(stale):
            print(f"  stale: {k} (x{stale[k]})", file=stream)
        print("  (fixed debt — remove with: python -m "
              "deeplearning4j_tpu_torch lint --update-baseline)", file=stream)
    return verdict


def report_json(new, known, stale, stream=None):
    doc = {"new": [f.to_json() for f in new],
           "baselined": [f.to_json() for f in known],
           "stale_baseline": dict(sorted(stale.items())),
           "counts": {"new": len(new), "baselined": len(known),
                      "stale": len(stale)}}
    stream = sys.stdout if stream is None else stream
    json.dump(doc, stream, indent=1)
    stream.write("\n")
    return doc


# ---------------------------------------------------------------------------
# schema artifact (lint --emit-schema)
# ---------------------------------------------------------------------------

def schema_json_text(schema):
    """The SCHEMA.json byte content for a build_schema() dict — keys
    sorted, newline-terminated, no timestamps, so identical source
    always renders identical bytes (the drift check byte-compares)."""
    return json.dumps(schema, indent=1, sort_keys=True) + "\n"


def metrics_md_text(schema):
    """METRICS.md: the human rendering of the same registry — the metric
    series table first (what operators grep for a label set), then the
    wire contract (routes, headers, response keys)."""
    lines = [
        "# Cluster schema — generated, do not edit",
        "",
        "Regenerate with `python -m deeplearning4j_tpu_torch lint "
        "--emit-schema`; `tests/test_torch_lint.py` fails when this "
        "file or `SCHEMA.json` is stale. The same harvest feeds lint "
        "rules R10 (wire contract), R11 (metric schema), and R13 "
        "(label cardinality).",
        "",
        "## Metric series",
        "",
        "| series | type | labels | optional | pre-registered | help |",
        "|---|---|---|---|---|---|",
    ]
    for name in sorted(schema["metrics"]):
        m = schema["metrics"][name]
        labels = ", ".join(m["labels"]) or "—"
        opt = ", ".join(m["optional_labels"]) or "—"
        if m["dynamic_labels"]:
            opt = (opt + " +**" if opt != "—" else "+**")
        pre = "yes" if m["preregistered"] else "no"
        help_ = m["help"].replace("|", "\\|")
        lines.append(f"| `{name}` | {m['type']} | {labels} | {opt} "
                     f"| {pre} | {help_} |")
    if schema.get("dynamic_metric_prefixes"):
        lines += ["",
                  "Dynamic series prefixes (name built at runtime): " +
                  ", ".join(f"`{p}*`"
                            for p in schema["dynamic_metric_prefixes"])]
    lines += ["", "## Wire contract", "", "### Routes", "",
              "| route | match | methods | handler sites |",
              "|---|---|---|---|"]
    for r in schema["wire"]["routes"]:
        sites = ", ".join(f"`{s}`" for s in r["sites"])
        lines.append(f"| `{r['path']}` | {r['match']} "
                     f"| {', '.join(r['methods'])} | {sites} |")
    lines += ["", "### Headers", ""]
    lines += [f"- `{h}`" for h in schema["wire"]["headers"]]
    lines += ["", "### Client call sites", "",
              "| route | site |", "|---|---|"]
    for c in schema["wire"]["client_calls"]:
        lines.append(f"| `{c['route']}` | `{c['site']}` |")
    lines += ["", "### Response-JSON keys", "",
              ", ".join(f"`{k}`" for k in schema["wire"]["response_keys"]),
              ""]
    return "\n".join(lines)


def default_schema_dir():
    """Where ``lint --emit-schema`` writes without ``--schema-dir``: the
    port's package's ``analysis/schema/``, never the repo root, whose
    ``SCHEMA.json`` and ``METRICS.md`` are the JAX package's."""
    import os
    return os.path.join(os.path.dirname(os.path.abspath(__file__)), "schema")


def write_schema(schema, out_dir=None):
    """Write SCHEMA.json + METRICS.md under ``out_dir`` (default
    :func:`default_schema_dir`, made if absent); returns the two paths
    written."""
    import os
    out_dir = out_dir or default_schema_dir()
    os.makedirs(out_dir, exist_ok=True)
    jp = os.path.join(out_dir, "SCHEMA.json")
    mp = os.path.join(out_dir, "METRICS.md")
    with open(jp, "w", encoding="utf-8") as fh:
        fh.write(schema_json_text(schema))
    with open(mp, "w", encoding="utf-8") as fh:
        fh.write(metrics_md_text(schema))
    return jp, mp
