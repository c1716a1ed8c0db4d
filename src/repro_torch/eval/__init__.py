"""Quality-evaluation subsystem of the port (counterpart of
``src/repro/eval``).

BEIR-style datasets (:mod:`repro_torch.eval.datasets`), batched metrics
on the device (:mod:`repro_torch.eval.metrics`), the grid sweep driving
the port's ``Retriever`` facade (:mod:`repro_torch.eval.sweep`), the
JSON/markdown report artifact (:mod:`repro_torch.eval.report`) and the
paper-envelope regression gate (:mod:`repro_torch.eval.gate`).
"""
from repro_torch.eval.datasets import (EvalDataset, from_corpus, load_beir,
                                 synthetic_dataset)
from repro_torch.eval.gate import (GateResult, PAPER_ENVELOPE, check_envelope,
                             check_regression, run_gate)
from repro_torch.eval.metrics import (DEFAULT_METRICS, PaddedQrels,
                                compute_metrics, first_hit_ranks,
                                metric_fn, mrr_at_k, ndcg_at_k,
                                parse_metric, ranked_gains,
                                rankings_matrix, recall_at_k,
                                success_at_k)
from repro_torch.eval.report import (BENCH_QUALITY_FILE, QualityBaseline,
                               QualityCell, QualityReport,
                               read_bench_section, write_bench_section)
from repro_torch.eval.sweep import (QualitySweep, relative_performance)

__all__ = [
    "BENCH_QUALITY_FILE",
    "DEFAULT_METRICS",
    "EvalDataset",
    "GateResult",
    "PAPER_ENVELOPE",
    "PaddedQrels",
    "QualityBaseline",
    "QualityCell",
    "QualityReport",
    "QualitySweep",
    "check_envelope",
    "check_regression",
    "compute_metrics",
    "first_hit_ranks",
    "from_corpus",
    "load_beir",
    "metric_fn",
    "mrr_at_k",
    "ndcg_at_k",
    "parse_metric",
    "ranked_gains",
    "rankings_matrix",
    "read_bench_section",
    "recall_at_k",
    "relative_performance",
    "run_gate",
    "success_at_k",
    "synthetic_dataset",
    "write_bench_section",
]
