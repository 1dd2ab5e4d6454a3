"""``chip_smoke.shared_pool_windows``: the f32 check of SegNet against a CPU
copy gives the copy the card's 2x2 first-maximum choices, and
``check_pool_windows`` accepts a window that the copy would pool
elsewhere only as a tie (its gap in the copy within ``POOL_TIE_REL`` of
the map's largest |value|, so a value that rounding moved across zero is
one), and only ``POOL_MAX_FLIPPED`` of them.  The card's forward is played here by
a first pooling call on other inputs."""

import numpy as np
import pytest
import torch

import chip_smoke
from jcfszxc_unet_tpu_torch.models import SegNet as segnet


def _maps(seed, n=2, c=3, h=8, w=8):
    """Random NCHW f32 maps in channels_last, as SegNet's pools get them,
    with every window's maximum unique by far."""
    rng = np.random.RandomState(seed)
    x = torch.from_numpy(rng.permutation(n * c * h * w).reshape(n, c, h, w)
                         .astype(np.float32))
    return x.contiguous(memory_format=torch.channels_last)


def _set_window(x, values, n=0, c=1, wy=1, wx=2):
    """Window (wy, wx) of channel c, image n, in (row, column) order."""
    x = x.clone()
    for k, v in enumerate(values):
        x[n, c, 2 * wy + k // 2, 2 * wx + k % 2] = v
    return x.contiguous(memory_format=torch.channels_last)


def _replay(card, cpu):
    """Record the card's choices on ``card``, replay them on ``cpu``;
    returns the log and the one-hot the CPU copy got."""
    with chip_smoke.shared_pool_windows() as log:
        segnet.max_pool2d_with_indices(card)
        log["replay"] = 0
        _, onehot = segnet.max_pool2d_with_indices(cpu)
    return log, onehot


def test_replay_gives_the_copy_the_cards_choices():
    card = _maps(0)
    cpu = _set_window(card, [5000.0, 0.0, 0.0, 0.0])
    card = _set_window(card, [0.0, 5000.0, 0.0, 0.0])
    log, onehot = _replay(card, cpu)
    _, want = segnet.max_pool2d_with_indices(card)
    assert torch.equal(onehot, want)
    assert log["flipped"] == 1


def test_a_tie_passes():
    one = torch.tensor(1000.0)
    up = float(torch.nextafter(one, torch.tensor(2000.0)))
    base = _maps(1)
    card = _set_window(base, [1000.0, up, 0.0, 0.0])   # card: position 1
    cpu = _set_window(base, [up, 1000.0, 0.0, 0.0])    # copy: position 0
    log, _ = _replay(card, cpu)
    assert (log["flipped"], log["untied"]) == (1, 0)
    assert log["gaps_rel"] == [pytest.approx((up - 1000.0) / float(cpu.max()))]
    chip_smoke.check_pool_windows(log)


def test_a_flip_across_zero_passes():
    """After conv-BN-ReLU one side's value is a rounding above zero and
    the other's is zero: millions of ulps of the window's maximum, but a
    tie on the map's scale."""
    base = _maps(4)
    card = _set_window(base, [0.0, 0.0, 0.0, 0.0])     # card: position 0
    cpu = _set_window(base, [0.0, 1e-8, 0.0, 0.0])     # copy: position 1
    log, _ = _replay(card, cpu)
    assert (log["flipped"], log["untied"]) == (1, 0)
    assert 0 < log["gaps_rel"][0] < chip_smoke.POOL_TIE_REL
    chip_smoke.check_pool_windows(log)


def test_a_flip_near_the_bound():
    """A gap just inside POOL_TIE_REL of the map passes, one just
    outside fails."""
    base = _maps(5)
    scale = float(base.max())
    for frac, untied in ((0.9, 0), (1.1, 1)):
        gap = frac * chip_smoke.POOL_TIE_REL * scale
        card = _set_window(base, [100.0, 100.0 - gap, 0.0, 0.0])
        cpu = card.clone()
        card = _set_window(card, [100.0 - gap, 100.0, 0.0, 0.0])
        log, _ = _replay(card, cpu)
        assert (log["flipped"], log["untied"]) == (1, untied)


def test_a_flip_that_is_no_tie_fails():
    base = _maps(2)
    card = _set_window(base, [1000.0, 1001.0, 0.0, 0.0])
    cpu = _set_window(base, [1500.0, 1000.0, 0.0, 0.0])
    log, _ = _replay(card, cpu)
    assert (log["flipped"], log["untied"]) == (1, 1)
    assert log["gaps_rel"][0] > chip_smoke.POOL_TIE_REL
    with pytest.raises(AssertionError, match="not ties"):
        chip_smoke.check_pool_windows(log)


def test_too_many_tied_flips_fail():
    one = torch.tensor(1000.0)
    up = float(torch.nextafter(one, torch.tensor(2000.0)))
    card = cpu = _maps(3, h=16, w=16)
    n = chip_smoke.POOL_MAX_FLIPPED + 1
    for i in range(n):
        card = _set_window(card, [1000.0, up, 0.0, 0.0], wy=i // 8,
                           wx=i % 8)
        cpu = _set_window(cpu, [up, 1000.0, 0.0, 0.0], wy=i // 8, wx=i % 8)
    log, _ = _replay(card, cpu)
    assert (log["flipped"], log["untied"]) == (n, 0)
    with pytest.raises(AssertionError, match="flipped"):
        chip_smoke.check_pool_windows(log)
