"""Regression gate: does pooling still sit inside the paper's envelope?
(Counterpart of ``src/repro/eval/gate.py``.)

Two checks, both over a :class:`~repro.eval.report.QualityReport`:

  * :func:`check_envelope` — the paper's quality claim as an
    assertion: factor-2 pooling keeps >= ``min_relative`` (default 95)
    of the unpooled metric ("50% reduction with virtually no
    degradation"; factors 3-4 sit inside ~5%). Any cell of the checked
    (method, factor) set below its floor is a failure.
  * :func:`check_regression` — cell-by-cell comparison against a
    PINNED baseline report (a committed ``BENCH_quality.json``
    section): a cell whose relative metric drops more than
    ``tolerance`` points below the pinned value fails. The tolerance
    absorbs cross-machine float drift; on the box that wrote the pin,
    the sweep is deterministic and reproduces it exactly.

``run_gate`` combines both into one :class:`GateResult`. The envelope
is the paper's claim about TRAINED encoders: at random weights it is a
reading, not a bar.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Sequence

from repro_torch.eval.report import QualityReport, read_bench_section

# The paper's envelope, by pooling factor: relative nDCG@10 floors.
# Factor 2 is the headline claim ("virtually no performance
# degradation"); 3 and 4 are the "<5% of performance" regime with a
# small allowance for the synthetic-corpus stand-ins.
PAPER_ENVELOPE = {2: 95.0, 3: 92.0, 4: 90.0}


@dataclass
class GateResult:
    ok: bool
    failures: List[str] = field(default_factory=list)
    checked: int = 0

    def __bool__(self) -> bool:
        return self.ok

    def summary(self) -> str:
        head = ("PASS" if self.ok else "FAIL") + \
            f" ({self.checked} checks"
        head += ")" if self.ok else f", {len(self.failures)} failures)"
        return "\n".join([head] + [f"  - {f}" for f in self.failures])


def check_envelope(report: QualityReport, metric: str = "ndcg@10",
                   envelope: Optional[dict] = None,
                   methods: Optional[Sequence[str]] = None,
                   min_relative: Optional[float] = None
                   ) -> GateResult:
    """Fail any cell whose relative ``metric`` falls below the paper
    envelope for its factor. ``methods`` restricts the check (the
    envelope is the paper's claim about hierarchical pooling; a CI
    smoke may gate ward only). ``min_relative`` overrides the factor-2
    floor alone — the headline gate."""
    env = dict(envelope if envelope is not None else PAPER_ENVELOPE)
    if min_relative is not None:
        env[2] = float(min_relative)
    failures, checked = [], 0
    for c in report.cells:
        if c.factor not in env or metric not in c.relative:
            continue
        if methods is not None and c.method not in methods:
            continue
        checked += 1
        floor = float(env[c.factor])
        if c.relative[metric] < floor:
            failures.append(
                f"envelope: {report.dataset} {c.backend} {c.method} "
                f"f={c.factor}"
                + (f" {c.quant_bits}b" if c.quant_bits else "")
                + f" relative {metric} {c.relative[metric]:.2f} "
                  f"< floor {floor:.2f}")
    if checked == 0:
        failures.append(f"envelope: no cells to check (metric "
                        f"{metric!r}, factors {sorted(env)})")
    return GateResult(ok=not failures, failures=failures, checked=checked)


def check_regression(report: QualityReport, pinned: QualityReport,
                     metric: str = "ndcg@10",
                     tolerance: float = 2.0) -> GateResult:
    """Fail any cell whose relative ``metric`` sits more than
    ``tolerance`` points BELOW the pinned report's value for the same
    (backend, method, factor, quant_bits). Cells absent from the pin
    are skipped (a grown grid is not a regression); improvements never
    fail."""
    failures, checked = [], 0
    for c in report.cells:
        p = pinned.cell(c.backend, c.method, c.factor, c.quant_bits)
        if p is None or metric not in c.relative \
                or metric not in p.relative:
            continue
        checked += 1
        drop = p.relative[metric] - c.relative[metric]
        if drop > float(tolerance):
            failures.append(
                f"regression: {report.dataset} {c.backend} {c.method} "
                f"f={c.factor}"
                + (f" {c.quant_bits}b" if c.quant_bits else "")
                + f" relative {metric} {c.relative[metric]:.2f} vs "
                  f"pinned {p.relative[metric]:.2f} "
                  f"(drop {drop:.2f} > tol {tolerance:.2f})")
    if checked == 0:
        failures.append("regression: no overlapping cells between the "
                        "report and the pinned baseline")
    return GateResult(ok=not failures, failures=failures, checked=checked)


def run_gate(report: QualityReport, metric: str = "ndcg@10",
             baseline_path: Optional[str] = None,
             baseline_section: str = "quality_sweep",
             envelope: Optional[dict] = None,
             methods: Optional[Sequence[str]] = None,
             min_relative: Optional[float] = None,
             tolerance: float = 2.0) -> GateResult:
    """Envelope check + (when ``baseline_path`` names a pinned
    ``BENCH_quality.json``) the regression check, folded into one
    result."""
    res = check_envelope(report, metric=metric, envelope=envelope,
                         methods=methods, min_relative=min_relative)
    failures, checked = list(res.failures), res.checked
    if baseline_path is not None:
        pinned = read_bench_section(baseline_path, baseline_section)
        if not isinstance(pinned, QualityReport):
            raise ValueError(
                f"{baseline_path}:{baseline_section} is not a quality "
                f"report")
        reg = check_regression(report, pinned, metric=metric,
                               tolerance=tolerance)
        failures.extend(reg.failures)
        checked += reg.checked
    return GateResult(ok=not failures, failures=failures, checked=checked)
