"""K6's real-input transform, in plain torch on the CPU: the layout that
``csrc/spectral_conv.cuh`` keeps (the half-length complex transform of the
packed pairs on the (n1, n2) four-step plane, rows held in pairs, the split
into the real spectrum and the packing back) against ``torch.fft``. The
kernels themselves run only on the card (``tests/test_torch_cuda.py``); this
holds the index rules they are written to.
"""

import pytest
import torch


def _split(length):
    """(n1, n2) of the half-length transform N = L: n1 = 2^ceil(e/2) >= n2."""
    e = length.bit_length() - 1
    n1 = 1 << ((e + 1) // 2)
    return n1, length // n1


def _slot_rows(n1):
    """The rows of each slot of the row pass: (0, n1/2), then (q, n1 - q)."""
    return [(0, n1 // 2)] + [(q, n1 - q) for q in range(1, n1 // 2)]


def _partner(k1, k2, n1, n2):
    """Where the row pass finds Z[N - k] for the element (k1, k2), k = k1 + n1 k2."""
    if k1 == 0:
        return 0, (n2 - k2) % n2
    return n1 - k1, n2 - 1 - k2


def _planes(length):
    n1, n2 = _split(length)
    k1 = torch.arange(n1)[:, None].expand(n1, n2)
    k2 = torch.arange(n2)[None, :].expand(n1, n2)
    p1 = torch.where(k1 == 0, torch.zeros_like(k1), n1 - k1)
    p2 = torch.where(k1 == 0, (n2 - k2) % n2, n2 - 1 - k2)
    return n1, n2, k1 + n1 * k2, p1, p2


@pytest.mark.parametrize("length", [8192, 16384, 32768, 65536, 131072])
def test_half_length_real_spectrum_matches_rfft(length):
    """The split of the packed transform gives torch.fft.rfft of the
    zero-padded sequence at every k (X[0] and X[N] from element 0), and the
    packing of that spectrum inverts back to the sequence."""
    n1, n2, k, p1, p2 = _planes(length)
    assert sorted(r for pair in _slot_rows(n1) for r in pair) == list(range(n1))
    for a, b in [(0, 0), (0, n2 // 2), (n1 // 2, 3), (5, 7), (n1 - 1, n2 - 1)]:
        q1, q2 = _partner(a, b, n1, n2)
        assert (q1 + n1 * q2) % length == (length - (a + n1 * b)) % length
    gen = torch.Generator().manual_seed(length)
    x = torch.randn(length, generator=gen, dtype=torch.float64)
    z = torch.zeros(length, dtype=torch.complex128)
    z[:length // 2] = torch.complex(x[0::2], x[1::2])
    zf = torch.fft.fft(z)
    plane = zf[k]                                   # plane[k1][k2] = Z[k1 + n1 k2]
    part = plane[p1, p2]                            # Z[N - k]
    w = torch.exp(-1j * torch.pi * k.double() / length)   # w_2N^k
    a = (plane + part.conj()) / 2
    bb = (plane - part.conj()) / 2j
    xk = a + w * bb
    ref = torch.fft.rfft(x, n=2 * length)
    assert torch.allclose(xk.reshape(-1)[torch.argsort(k.reshape(-1))], ref[:length],
                          atol=1e-9 * ref.abs().max())
    assert abs((a - w * bb)[0, 0].conj() - ref[length]) <= 1e-9 * ref.abs().max()
    # the packing back: Zy[k] = (Y[k] + conj Y[N-k]) / 2 + i conj(w) (Y[k] - conj Y[N-k]) / 2
    yk = xk.clone()
    yp = (a - w * bb).conj()                        # X[N - k] from the same pair
    zy = (yk + yp.conj()) / 2 + 1j * w.conj() * (yk - yp.conj()) / 2
    back = torch.zeros(length, dtype=torch.complex128)
    back[k.reshape(-1)] = zy.reshape(-1)
    y = torch.fft.ifft(back)
    assert torch.allclose(y.real[:length // 2], x[0::2], atol=1e-9)
    assert torch.allclose(y.imag[:length // 2], x[1::2], atol=1e-9)
