"""The port's rotary embedding against the JAX `_rope` on the CPU, f32.

Each `rope_scaling` kind the reference converts (linear, llama3, yarn
with the paper's attention factor and with an mscale pair's, and phi3's
longrope in both bands), at the JAX tests' head dim 16 and at 80 and 96,
the partial rotary of phi-2 (0.4 of 80: 32 dims) and GPT-NeoX (0.25 of
96: 24 dims), and longrope's per-row band choice from `regime_len` in a
batch that mixes the bands.  Tolerance 1e-6.

The base inverse frequencies are exp(-ln(theta) i / half) in f32 on both
sides, and XLA's f32 exp and PyTorch's differ by one ulp at some i (so do
both from the correctly rounded value).  A position p turns that ulp into
p ulps of the angle: 4e-4 at position 4600 and D 96, 3e-6 at 31.  So the
frequency tables are held to JAX's within four ulps (`test_rope_tables_*`:
llama3's ramp weighs each frequency by a function of itself, so a one-ulp
input moves its output by up to two),
and the rotation itself, with the port's tables set to JAX's exact f32
values, to 1e-6 at every position (cos and sin of the same f32 angle agree
within 2.4e-7 on both sides).

Also: the frequency tables are made once per device and kept (a captured
decode group reads them by address), the longrope band of a decode row
is chosen on the device from its position alone, and `rope_tables`
refuses an unknown kind by name.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.models.transformer import _rope as jax_rope
from deepspeed_tpu.models.transformer import (
    _scale_rope_freqs as jax_scale_freqs)
from deepspeed_tpu_torch.models import transformer as tt

pytestmark = pytest.mark.serving

ROPE_TOL = dict(rtol=1e-6, atol=1e-6)
THETA = 10000.0


def _yarn_factor(factor, mscale=None, mscale_all_dim=None):
    """HF _compute_yarn_parameters' attention factor (the reference's
    conversion)."""
    def get(scale, ms=1.0):
        return 1.0 if scale <= 1 else 0.1 * ms * math.log(scale) + 1.0
    if mscale and mscale_all_dim:
        return get(factor, mscale) / get(factor, mscale_all_dim)
    return get(factor)


def _longrope(half, orig=32.0, factor=4.0):
    """A longrope tuple of `half` factors a band, rising from 1.0 as the
    published lists do, with HF's attention factor for `factor`."""
    af = math.sqrt(1.0 + math.log(factor) / math.log(orig))
    return ("longrope", af, orig,
            tuple(1.0 + 0.03 * i for i in range(half)),
            tuple(1.0 + 0.5 * i for i in range(half)))


def _scalings(half):
    return {
        "none": None,
        "linear": ("linear", 4.0),
        "llama3": ("llama3", 8.0, 1.0, 4.0, 64.0),
        "yarn": ("yarn", 4.0, _yarn_factor(4.0), 32.0, 1.0, 64.0),
        "yarn_mscale": ("yarn", 4.0, _yarn_factor(4.0, 1.0, 0.8), 32.0, 1.0,
                        64.0),
        "longrope": _longrope(half),
    }


def _jax_tables(half, scaling):
    """JAX's f32 frequency tables for `scaling`, in `rope_tables`' form:
    the base exp(-ln(theta) i / half) by jnp.exp, scaled by the JAX
    `_scale_rope_freqs`, or divided by longrope's factor lists."""
    freqs = np.array(jnp.exp(-math.log(THETA)
                              * jnp.arange(half, dtype=jnp.float32) / half))
    if scaling is None:
        return freqs, None, None
    if scaling[0] == "longrope":
        return (freqs / np.asarray(scaling[3], np.float32),
                freqs / np.asarray(scaling[4], np.float32), scaling[1])
    scaled = np.array(jax_scale_freqs(jnp.asarray(freqs), scaling, THETA))
    return scaled, None, scaling[2] if scaling[0] == "yarn" else None


@pytest.fixture
def jax_freqs(monkeypatch):
    """Set the port's cached frequency tables to JAX's f32 values (see
    the module docstring)."""
    def pin(half, scaling):
        short, long_, factor = _jax_tables(half, scaling)
        monkeypatch.setitem(tt._ROPE, (half, THETA, scaling,
                                       torch.device("cpu")),
                            (torch.from_numpy(short),
                             None if long_ is None
                             else torch.from_numpy(long_), factor))
    return pin


def _both(x, pos, pct, scaling, regime=None):
    got = tt._rope(torch.from_numpy(x), torch.from_numpy(pos), THETA, pct,
                   scaling,
                   regime_len=None if regime is None
                   else torch.from_numpy(regime))
    want = jax_rope(jnp.asarray(x), jnp.asarray(pos), THETA, pct, scaling,
                    regime_len=None if regime is None
                    else jnp.asarray(regime))
    return got.numpy(), np.asarray(want)


def _rotated_half(D, pct):
    rd = (int(D * pct) // 2) * 2 if pct < 1.0 else D
    return rd // 2


@pytest.mark.parametrize("kind", ["none", "linear", "llama3", "yarn",
                                  "yarn_mscale", "longrope"])
@pytest.mark.parametrize("D,pct", [(16, 1.0), (80, 1.0), (96, 1.0),
                                   (80, 0.4), (96, 0.25)],
                         ids=["d16", "d80", "d96", "d80-pct0.4",
                              "d96-pct0.25"])
@pytest.mark.parametrize("band", ["short", "long"])
def test_rope_matches_jax(kind, D, pct, band, jax_freqs):
    """x [3, 9, 2, D] at positions inside (short) or far past (long, to
    4600 as Phi-3's phase-15 prompts) the original context of 32: every
    scaling kind alike; only longrope's output depends on the band."""
    rng = np.random.RandomState(D + len(kind))
    half = _rotated_half(D, pct)
    scaling = _scalings(half)[kind]
    jax_freqs(half, scaling)
    x = rng.randn(3, 9, 2, D).astype(np.float32)
    hi = 31 if band == "short" else 4600
    pos = np.sort(rng.randint(0, hi - 8, (3, 9)), axis=1).astype(np.int64)
    pos[:, -1] = hi - 1 - rng.randint(0, 3, 3)
    got, want = _both(x, pos, pct, scaling)
    np.testing.assert_allclose(got, want, **ROPE_TOL)
    if pct < 1.0:
        rd = 2 * _rotated_half(D, pct)
        assert rd == {80: 32, 96: 24}[D]
        np.testing.assert_array_equal(got[..., rd:], x[..., rd:])


@pytest.mark.parametrize("D,pct", [(16, 1.0), (96, 1.0), (80, 0.4)])
def test_longrope_regime_len_mixes_the_bands_per_row(D, pct, jax_freqs):
    """A chunk batch whose rows take different bands from their whole
    prompt lengths (`regime_len`), not their chunk positions: the first
    chunk of a 50-token prompt (positions 0-15) embeds in the long band,
    a short prompt's in the short band, as HF's one-shot forward of each
    prompt does."""
    rng = np.random.RandomState(5)
    scaling = _longrope(_rotated_half(D, pct))
    jax_freqs(_rotated_half(D, pct), scaling)
    x = rng.randn(4, 16, 2, D).astype(np.float32)
    pos = np.stack([np.arange(16) + p0 for p0 in (0, 0, 16, 16)]).astype(
        np.int64)
    regime = np.asarray([50, 20, 50, 32], np.int64)
    got, want = _both(x, pos, pct, scaling, regime)
    np.testing.assert_allclose(got, want, **ROPE_TOL)
    # row 0 (long band) differs from the same positions in the short band
    short, _ = _both(x[:1], pos[:1], pct, scaling, regime[1:2])
    assert not np.allclose(got[0], short[0])
    # without regime_len each row's band follows its own max position
    got_pos, want_pos = _both(x, pos, pct, scaling)
    np.testing.assert_allclose(got_pos, want_pos, **ROPE_TOL)


def test_decode_rows_switch_band_at_the_original_context(jax_freqs):
    """A decode row (one position, no regime_len) takes the short band up
    to position orig - 1 and the long band from orig on, on the device."""
    scaling = _longrope(8, orig=32.0)
    jax_freqs(8, scaling)
    x = np.random.RandomState(1).randn(4, 1, 1, 16).astype(np.float32)
    pos = np.asarray([[30], [31], [32], [33]], np.int64)
    got, want = _both(x, pos, 1.0, scaling)
    np.testing.assert_allclose(got, want, **ROPE_TOL)
    freqs, long_freqs, factor = tt.rope_tables(8, THETA, scaling, "cpu")
    for row, table in ((1, freqs), (2, long_freqs)):
        ang = pos[row, 0] * table.numpy()
        x1, x2 = x[row, 0, 0, :8], x[row, 0, 0, 8:]
        ref = np.concatenate([x1 * np.cos(ang) - x2 * np.sin(ang),
                              x1 * np.sin(ang) + x2 * np.cos(ang)]) * factor
        np.testing.assert_allclose(got[row, 0, 0], ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("kind", ["none", "linear", "llama3", "yarn",
                                  "yarn_mscale", "longrope"])
@pytest.mark.parametrize("half", [8, 12, 16, 40, 48])
def test_rope_tables_match_jax_within_four_ulps(kind, half):
    """The port's frequency tables (torch's f32 exp, then the scaling)
    against JAX's (XLA's f32 exp, then the JAX scaling): four ulps."""
    scaling = _scalings(half)[kind]
    got = tt.rope_tables(half, THETA, scaling, "cpu")
    want = _jax_tables(half, scaling)
    for g, w in zip(got[:2], want[:2]):
        assert (g is None) == (w is None)
        if w is not None:
            np.testing.assert_allclose(g.numpy(), w, rtol=2 ** -21, atol=0)
    assert got[2] == want[2]


def test_rope_tables_are_made_once_per_device():
    scaling = _longrope(48)
    a = tt.rope_tables(48, THETA, scaling, "cpu")
    b = tt.rope_tables(48, THETA, scaling, torch.device("cpu"))
    assert a is b and a[0].shape == a[1].shape == (48,)
    plain = tt.rope_tables(48, THETA, None, "cpu")
    assert plain[1] is None and plain[2] is None
    yarn = tt.rope_tables(8, THETA, _scalings(8)["yarn"], "cpu")
    assert yarn[2] == pytest.approx(_yarn_factor(4.0))
    with pytest.raises(ValueError, match="rope_scaling kind"):
        tt.rope_tables(8, THETA, ("dynamic", 2.0), "cpu")
