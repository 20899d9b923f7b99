"""The windowed scan's gate (K9, ``ops.selective_scan_window``): on CPU tensors
the JAX package's own (``selective_scan_pallas.pallas_scan_supported``: L <=
64, N * d <= 8192, at least 2048 windows, a crossover measured on a TPU), on
CUDA tensors the card's floor of WINDOW_SCAN_MIN_BATCH_CUDA windows with the
same L and N * d limits, so that micro_w7's and vessel's calls under 2048
windows take K9 on the card and not the sequential scan."""

import pytest

from long_context_biomedical_imaging_tpu.ops import selective_scan_pallas as jpallas
from long_context_biomedical_imaging_tpu_torch.models import mamba as tmamba
from long_context_biomedical_imaging_tpu_torch.ops import selective_scan_window as twin

# (L, N, d, windows or None): test_torch_micro.py's table of the gates
TABLE = [(49, 8, 48, 21904), (49, 8, 96, 5476), (49, 8, 192, 1444), (64, 8, 1024, 2048),
         (64, 8, 1025, 4096), (65, 8, 8, 4096), (9, 8, 48, 2047), (4, 8, 16, None)]
# calls under the JAX package's floor: micro_w7's stages 2-3 and vessel's
# stage 3 at batch 4 on 1024x1024, 32 windows of 64 tokens, one window
SMALL = [(49, 8, 192, 1444), (49, 8, 384, 400), (64, 8, 384, 256), (64, 8, 384, 32),
         (49, 8, 96, 1)]


@pytest.mark.parametrize("args", TABLE)
def test_cpu_window_gate_is_jax(args):
    """Without ``cuda`` (and with cuda=False, as the mixer passes it for a
    CPU tensor) the gate is JAX's on every shape of the table."""
    length, n, d, batch = args
    want = jpallas.pallas_scan_supported(length, n, d, batch=batch)
    assert twin.window_scan_supported(length, n, d, batch=batch) == want
    assert twin.window_scan_supported(length, n, d, batch=batch, cuda=False) == want


@pytest.mark.parametrize("args", SMALL)
def test_card_window_gate_admits_small_calls(args):
    """The card's gate takes the calls JAX's floor refuses; the CPU's does
    not."""
    length, n, d, batch = args
    assert twin.window_scan_supported(length, n, d, batch=batch, cuda=True)
    assert not twin.window_scan_supported(length, n, d, batch=batch)
    assert not jpallas.pallas_scan_supported(length, n, d, batch=batch)


def test_card_window_gate_keeps_the_limits():
    """The card's floor moves only the window count: L > 64 and N d > 8192
    stay refused at any count, the floor is one window, and the mixer reads
    the gate through its own alias."""
    assert twin.WINDOW_SCAN_MIN_BATCH_CUDA == 1 and twin.WINDOW_SCAN_MIN_BATCH == 2048
    for cuda in (False, True):
        assert not twin.window_scan_supported(65, 8, 8, batch=4096, cuda=cuda)
        assert not twin.window_scan_supported(64, 8, 1025, batch=4096, cuda=cuda)
        assert not twin.window_scan_supported(49, 16, 513, batch=1, cuda=cuda)
    assert not twin.window_scan_supported(49, 8, 96, batch=0, cuda=True)
    assert tmamba._window_scan_supported is twin.window_scan_supported
