"""graftlint for the port: static analysis of the PyTorch/CUDA step path.

The port's own copy of the JAX package's ``analysis/``: the framework
(findings, the rule registry, ``# graftlint: disable=R<n> -- reason``
suppressions, baselines, reporters, ``--diff``) carries over as is, and
the rules that encode JAX idioms are re-derived for the port's. The
failure mode stays the one the reference inherits (SURVEY.md): host code
silently forcing device->host syncs in the training/serving step path,
or work that silently runs once where it should run every step.

* ``R1 host-sync``          — ``.item()``/``.tolist()``/``.cpu()``/
  ``.numpy()``, ``float()``/``int()``/``bool()`` of a tensor and
  ``torch.cuda.synchronize()`` inside a CUDA-graph capture body, or per
  iteration on step-fn results in fit/dispatch loops.
* ``R2 captured-branch``    — Python ``if``/``while`` on a device value
  inside a capture body (a replay runs the branch the capture took).
* ``R3 recapture``          — a CUDA-graph capture, ``torch.compile`` or
  kernel build inside a loop (``torch.utils.checkpoint`` compiles
  nothing and is not flagged).
* ``R4 impure-capture``     — host RNG, clocks, telemetry, ``print`` or
  I/O inside a capture body: run once at capture, never at replay.
* ``R5 backend-guard``      — ``torch.cuda`` memory/device queries
  outside an availability guard or a ``try``.
* ``R6 thread-discipline``  — threads without an explicit ``daemon``
  flag; read-modify-write of shared attributes outside the owning lock.

``flow_rules`` adds the project-level dataflow rules R7-R9 (a captured
graph's static output kept across replays, collectives on groups nobody
opened, lock order / blocking under a lock); ``contracts`` adds the
distributed tier's string contracts R10-R13 (wire contract, metric
schema, blocking-call timeouts on the fleet paths, label cardinality)
plus ``lint --emit-schema``, which writes the harvested wire+metric
registry to ``analysis/schema/SCHEMA.json`` and ``METRICS.md`` inside
this package (never the repo root's, which are the JAX package's).

Pure stdlib (``ast`` + ``tokenize``) — importing this package never
imports torch, so the linter runs anywhere without an accelerator stack.

Usage::

    python -m deeplearning4j_tpu_torch lint                     # whole port
    python -m deeplearning4j_tpu_torch lint --rules R1 deeplearning4j_tpu_torch/nn
    python -m deeplearning4j_tpu_torch lint --strict-baseline   # the CI gate

Suppress a deliberate finding on its line with a justification::

    loss.item()  # graftlint: disable=R1 -- one read an epoch, after the loop

Pre-existing findings live in ``analysis/graftlint.baseline.json``
beside this file; ``--update-baseline`` rewrites it, ``--strict-baseline``
also fails on stale entries so the baseline only ever shrinks.
"""

from deeplearning4j_tpu_torch.analysis.core import (Finding, LintError,
                                                    LintModule, ProjectRule,
                                                    all_rules, lint_modules,
                                                    lint_paths, lint_source,
                                                    parse_paths)
from deeplearning4j_tpu_torch.analysis.baseline import (apply_baseline,
                                                        default_baseline_path,
                                                        load_baseline,
                                                        save_baseline)
from deeplearning4j_tpu_torch.analysis import rules as _rules  # R1-R6
from deeplearning4j_tpu_torch.analysis import flow_rules as _flow  # R7-R9
from deeplearning4j_tpu_torch.analysis import contracts as _contracts  # R10-R13
from deeplearning4j_tpu_torch.analysis.contracts import build_schema

__all__ = ["Finding", "LintError", "LintModule", "ProjectRule", "all_rules",
           "lint_modules", "lint_paths", "lint_source", "parse_paths",
           "apply_baseline", "default_baseline_path", "load_baseline",
           "save_baseline", "build_schema"]
