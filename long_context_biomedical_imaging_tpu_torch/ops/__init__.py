from .fused_mlp import (fast_layernorm, fused_ln_mlp_residual, fused_ln_mlp_residual_bwd,
                        fused_ln_mlp_residual_bwd_plain, fused_ln_mlp_residual_plain)
from .hyena_window import (HYENA_WINDOW_MAX_LEN, hyena_window_bwd, hyena_window_bwd_plain,
                           hyena_window_mixer, hyena_window_plain, prepare_taps)
from .window import (compute_shift_regions, get_window_size, pad_to_window_multiple,
                     relative_position_index, window_partition, window_reverse)
from .window_attention import windowed_attention_proj

__all__ = [
    "fast_layernorm", "fused_ln_mlp_residual", "fused_ln_mlp_residual_bwd",
    "fused_ln_mlp_residual_bwd_plain", "fused_ln_mlp_residual_plain",
    "HYENA_WINDOW_MAX_LEN", "hyena_window_bwd", "hyena_window_bwd_plain",
    "hyena_window_mixer", "hyena_window_plain", "prepare_taps",
    "compute_shift_regions", "get_window_size", "pad_to_window_multiple",
    "relative_position_index", "window_partition", "window_reverse", "windowed_attention_proj",
]
