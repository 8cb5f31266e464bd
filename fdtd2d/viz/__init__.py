from fdtd2d.viz.render import (
    field_to_rgb, capture_snapshot, plot_Ez, save_frames, make_video_from_frames,
    render_video,
)
from fdtd2d.viz.plots import (
    plot_sparsity, plot_convergence, plot_ref_v_inference, plot_noisy_sample,
    plot_frequency_response,
)

__all__ = [
    "field_to_rgb", "capture_snapshot", "plot_Ez", "save_frames",
    "make_video_from_frames", "render_video", "plot_sparsity",
    "plot_convergence", "plot_ref_v_inference", "plot_noisy_sample",
    "plot_frequency_response",
]
