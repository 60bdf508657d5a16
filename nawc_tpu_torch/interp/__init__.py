from .probe import get_latent, get_mean_latent, project_on_axis
from .manifold import estimate_axis, trajectory_stats, run_manifold_analysis, projection_stats
from .ablation import run_layer_ablation, ablation_heatmap
from .uncertainty import (
    monte_carlo_scores,
    mc_statistics,
    reliability_curve,
    variance_error_auc,
    expected_calibration_error,
)
from .saliency import input_gradient, integrated_gradients, saliency_spectrogram, topk_salient_frames
from .feature_importance import compute_feature_importance, agg_stats
from .spectral import band_energies, residual_report

__all__ = [
    "get_latent", "get_mean_latent", "project_on_axis",
    "estimate_axis", "trajectory_stats", "run_manifold_analysis", "projection_stats",
    "run_layer_ablation", "ablation_heatmap",
    "monte_carlo_scores", "mc_statistics", "reliability_curve",
    "variance_error_auc", "expected_calibration_error",
    "input_gradient", "integrated_gradients", "saliency_spectrogram", "topk_salient_frames",
    "compute_feature_importance", "agg_stats",
    "band_energies", "residual_report",
]
