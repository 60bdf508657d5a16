from .benchmark import (
    DEFAULT_THRESHOLDS,
    CombinedReport,
    detection_auc,
    find_optimal_threshold,
    run_combined,
    run_detector_checker,
    run_survivability,
)
from . import reporting
from .metrics import lsd, pesq_host, si_sdr, si_snr, snr, stoi
from .quality import evaluate_pair_batch, evaluate_pairs, make_pairs
from .robustness import (
    chunk_audio,
    overall_stats,
    read_csv,
    run_robustness,
    stats_by_attack,
    write_csv,
    write_results_csv,
)

__all__ = [
    "si_snr", "snr", "lsd", "stoi", "si_sdr", "pesq_host",
    "run_detector_checker", "run_survivability", "run_combined", "CombinedReport",
    "find_optimal_threshold", "detection_auc", "DEFAULT_THRESHOLDS",
    "run_robustness", "chunk_audio", "write_results_csv", "write_csv", "read_csv",
    "overall_stats", "stats_by_attack",
    "evaluate_pairs", "evaluate_pair_batch", "make_pairs",
    "reporting",
]
