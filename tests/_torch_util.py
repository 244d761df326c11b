"""Shared fixture of the PyTorch port's CPU tests.

The port's tests run many small tensor ops; with torch's default
intra-op thread pool per process, the parallel test workers oversubscribe
the cores they share. Import ``one_torch_thread`` into a test module to
run that module's torch ops on one thread (restored afterwards)."""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def noisy_view_planes(h, w, elements, pad, seed=0, pitch_extra=0):
    """Per-view head outputs of an (h, w) frame, made with numpy: for each
    dihedral element ``(k, flip)`` a (3, Hp, P) float32 array with standard
    normal ``[vx, vy, mask]`` in the view's crop ((w, h) for odd k) and
    large noise (+-1e3) in the padding around it, which a kernel must never
    read. Hp and P are ``pad`` or the crop, whichever is larger; P is then
    rounded up to a multiple of 4 and widened by ``pitch_extra``.
    Returns ``[(planes, crop, element)]``."""
    import numpy as np

    rng = np.random.default_rng(seed)
    out = []
    for k, flip in elements:
        crop = (w, h) if k % 2 else (h, w)
        hp = max(pad, crop[0])
        pitch = -(-max(pad, crop[1]) // 4) * 4 + pitch_extra
        planes = rng.uniform(-1e3, 1e3, (3, hp, pitch)).astype(np.float32)
        planes[:, :crop[0], :crop[1]] = rng.normal(
            size=(3,) + crop).astype(np.float32)
        out.append((planes, crop, (k, flip)))
    return out
