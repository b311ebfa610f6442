"""The PyTorch port's 8-bit Adam (state_dtype "int8", fused_update)
against the JAX package, on the CPU.

Inputs are drawn with numpy from fixed seeds and fed to both sides; the
port runs the fused kernel's plain version (CPU tensors), the JAX side its
Pallas kernel in interpret mode or its jnp update.  Covered:

- `fused_adam8_leaf_reference` against the JAX `fused_adam8_leaf` on
  tests/test_fused_adam8.py's shapes, with that test's tolerances (master
  rtol 1e-6 / atol 1e-7, codes within one, scales rtol 1e-6);
- the port's int8 `update` against the JAX `_make_adam_int8` update,
  three steps, also on a row length that is not a multiple of 128 and a
  0-d leaf; `update_fused` (in place) equal to `update`;
- the folded gradient scale;
- the engine with int8 moments and `fused_update` against the JAX engine
  (f32 and bf16 compute), from the JAX engine's int8 state
  (`opt_state_from_jax`), and through its fused branch;
- `fused_update` with fp32, bf16 and int8f moments: accepted and ignored,
  as in the JAX package.

Why codes may differ by one: PyTorch's and XLA's CPU `exp2` and `log2`
differ in the last bit for most arguments (195 of the 256 decoded v
levels, a third of random `log2` inputs), so a v code whose value lands
within an ulp of a rounding boundary may round the other way, and the
row max of v (the v scale) may differ in its last bit.  The m codes and
scales use no transcendental and agree exactly in these tests.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu as dstpu
from deepspeed_tpu.config.config import OptimizerConfig as JOptCfg
from deepspeed_tpu.models import Transformer as JTransformer
from deepspeed_tpu.models import gpt2_config as jgpt2
from deepspeed_tpu.ops.fused_adam8 import fused_adam8_leaf as jfused
from deepspeed_tpu.runtime import optimizers as jopt

import deepspeed_tpu_torch as dt
from deepspeed_tpu_torch.config.config import OptimizerConfig as TOptCfg
from deepspeed_tpu_torch.models import Transformer as TTransformer
from deepspeed_tpu_torch.models import gpt2_config as tgpt2
from deepspeed_tpu_torch.models import opt_state_from_jax
from deepspeed_tpu_torch.ops import fused_adam8 as tfa
from deepspeed_tpu_torch.runtime import engine as tengine
from deepspeed_tpu_torch.runtime import optimizers as topt

pytestmark = pytest.mark.kernels

B1, B2, EPS, WD = 0.9, 0.999, 1e-8, 0.1
HYPER = dict(b1=B1, b2=B2, eps=EPS, wd=WD, adam_w=True)
SHAPES = [(256, 256), (8, 32, 128), (384,), (3, 128)]
MASTER_TOL = dict(rtol=1e-6, atol=1e-7)
# f32 training steps, as tests/test_torch_port_training.py: the engines
# agree to a few f32 ulps of the loss; grad norms sum every element
STEP_TOL = dict(loss=1e-5, grad_norm=1e-4)
# bf16 compute rounds at other places in the two frameworks (measured
# there at 7e-5 loss, 3e-3 grad norm over 5 steps)
BF16_STEP_TOL = dict(loss=1e-3, grad_norm=2e-2)
TINY = dict(hidden_size=64, num_heads=2, num_layers=2, max_seq_len=64,
            vocab_size=256)


def _t(a):
    return torch.from_numpy(np.array(a))


def _codes_close(got, want, what):
    """Codes within one; returns the share that differ."""
    d = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert d.max() <= 1, what
    return float((d > 0).mean())


def _leaf_inputs(shape, seed):
    """Master, bf16-valued gradient and moments after one real quantized
    step (JAX's codecs), as numpy arrays."""
    rng = np.random.RandomState(seed)
    p = (rng.randn(*shape) * 0.1).astype(np.float32)
    g = np.asarray(jnp.asarray(rng.randn(*shape) * 1e-3, jnp.bfloat16)
                   .astype(jnp.float32))
    m0 = jnp.asarray(rng.randn(*shape) * 1e-3, jnp.float32)
    m_q, m_s = jopt._q8_signed(m0)
    v_q, v_s = jopt._q8_log(m0 * m0)
    return p, g, [np.asarray(x) for x in (m_q, m_s, v_q, v_s)]


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_plain_leaf_matches_the_pallas_kernel(shape):
    p, g, (m_q, m_s, v_q, v_s) = _leaf_inputs(shape, 0)
    c1, c2 = 1.0 - B1 ** 2, 1.0 - B2 ** 2
    want = jfused(jnp.asarray(g, jnp.bfloat16), *map(jnp.asarray, (
        m_q, m_s, v_q, v_s, p)), 1e-3, 1.0, c1, c2, bias_correction=True,
        interpret=True, **HYPER)
    got = tfa.fused_adam8_leaf(_t(g).bfloat16(), *map(_t, (
        m_q, m_s, v_q, v_s, p)), 1e-3, 1.0, c1, c2, **HYPER)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               **MASTER_TOL)
    assert torch.equal(got[1], got[0].bfloat16())
    _codes_close(got[2].numpy(), np.asarray(want[2]), "m codes")
    _codes_close(got[4].numpy(), np.asarray(want[4]), "v codes")
    for i in (3, 5):
        np.testing.assert_allclose(got[i].numpy().ravel(),
                                   np.asarray(want[i]).ravel(), rtol=1e-6)


def _opt(state_dtype, **extra):
    return {"type": "adamw", "params": dict(
        {"lr": 1e-2, "weight_decay": 0.1, "state_dtype": state_dtype},
        **extra)}


def _tree(rng, shapes):
    return {f"w{i}": np.asarray(rng.randn(*s), np.float32)
            for i, s in enumerate(shapes)}


@pytest.mark.parametrize("shapes", [SHAPES, [(5, 100), ()]],
                         ids=["kernel-shapes", "rows-of-100-and-0d"])
def test_int8_update_matches_jax(shapes):
    """Three updates from the initial state, grad_scale folded: masters
    within f32 rounding (the bias corrections are f32 pows in JAX, Python
    floats here), codes within one, scales rtol 1e-6."""
    rng = np.random.RandomState(3)
    jo = jopt.build_optimizer(JOptCfg(**_opt("int8")))
    to = topt.build_optimizer(TOptCfg(**_opt("int8")))
    master = _tree(rng, shapes)
    jm = {k: jnp.asarray(v) for k, v in master.items()}
    tm = {k: _t(v) for k, v in master.items()}
    js, ts = jo.init(jm), to.init(tm)
    for key in js:
        for k in master:
            assert ts[key][k].shape == tuple(js[key][k].shape)
            np.testing.assert_array_equal(ts[key][k].numpy(),
                                          np.asarray(js[key][k]))
    for step in (1, 2, 3):
        g = {k: np.asarray(rng.randn(*v.shape) * np.exp(rng.randn()),
                           np.float32) for k, v in master.items()}
        jm, js = jo.update({k: jnp.asarray(v) for k, v in g.items()}, js, jm,
                           1e-2, jnp.float32(step),
                           grad_scale=jnp.float32(0.5))
        tm, ts = to.update({k: _t(v) for k, v in g.items()}, ts, tm, 1e-2,
                           float(step), grad_scale=torch.tensor(0.5))
    for k in master:
        np.testing.assert_allclose(tm[k].numpy(), np.asarray(jm[k]),
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_array_equal(ts["m"][k].numpy(),
                                      np.asarray(js["m"][k]))
        np.testing.assert_array_equal(ts["m_scale"][k].numpy(),
                                      np.asarray(js["m_scale"][k]))
        _codes_close(ts["v"][k].numpy(), np.asarray(js["v"][k]), "v codes")
        np.testing.assert_allclose(ts["v_scale"][k].numpy(),
                                   np.asarray(js["v_scale"][k]), rtol=1e-6)


def test_update_fused_writes_what_update_returns():
    """`update_fused` (the wrapper's plain version on the CPU) writes into
    the given trees exactly what `update` returns, the cast included, for
    leaves with ndim >= 1 and a 0-d leaf."""
    rng = np.random.RandomState(4)
    opt = topt.build_optimizer(TOptCfg(**_opt("int8", fused_update=True)))
    assert opt.update_fused is not None
    shapes = [(6, 40), (7,), ()]
    master = {k: _t(v) for k, v in _tree(rng, shapes).items()}
    state = opt.init(master)
    fm = {k: v.clone() for k, v in master.items()}
    fs = {key: {k: v.clone() for k, v in t.items()}
          for key, t in state.items()}
    params = {k: v.bfloat16() for k, v in master.items()}
    for step in (1, 2):
        g = {k: _t(v).bfloat16() for k, v in _tree(rng, shapes).items()}
        gs = torch.tensor(0.25)
        master, state = opt.update(g, state, master, 1e-2, float(step),
                                   grad_scale=gs)
        ids = {k: v.data_ptr() for k, v in fm.items()}
        out = opt.update_fused(g, fs, fm, 1e-2, float(step), params,
                               grad_scale=gs)
        assert out[0] is fm and out[1] is params and out[2] is fs
        assert {k: v.data_ptr() for k, v in fm.items()} == ids
        for k in master:
            assert torch.equal(fm[k], master[k])
            assert torch.equal(params[k], master[k].bfloat16())
            for key in state:
                assert torch.equal(fs[key][k], state[key][k])


def test_gscale_folds_grad_scaling():
    """JAX's test_gscale_folds_grad_scaling: a gradient scaled by 0.25
    outside equals gscale 0.25 inside."""
    rng = np.random.RandomState(1)
    shape = (16, 128)
    p = _t((rng.randn(*shape) * 0.1).astype(np.float32))
    g = _t(rng.randn(*shape).astype(np.float32))
    m_q, m_s = topt._q8_signed(torch.zeros(shape))
    v_q, v_s = topt._q8_log(torch.zeros(shape))
    kw = dict(b1=B1, b2=B2, eps=EPS, wd=0.0, adam_w=True)
    a = tfa.fused_adam8_leaf(g * 0.25, m_q, m_s, v_q, v_s, p, 1e-3, 1.0,
                             1 - B1, 1 - B2, **kw)
    b = tfa.fused_adam8_leaf(g, m_q, m_s, v_q, v_s, p, 1e-3,
                             torch.tensor(0.25), 1 - B1, 1 - B2, **kw)
    np.testing.assert_allclose(a[0].numpy(), b[0].numpy(), **MASTER_TOL)
    jm_q, jm_s = jopt._q8_signed(jnp.zeros(shape))
    jv_q, jv_s = jopt._q8_log(jnp.zeros(shape))
    want = jfused(jnp.asarray(g.numpy()), jm_q, jm_s, jv_q, jv_s,
                  jnp.asarray(p.numpy()), 1e-3, 0.25, 1 - B1, 1 - B2,
                  bias_correction=True, interpret=True, **kw)
    np.testing.assert_allclose(b[0].numpy(), np.asarray(want[0]),
                               **MASTER_TOL)


def test_fused_update_is_ignored_without_int8_moments():
    """fp32, bf16 and int8f optimizers take fused_update and ignore it (the
    JAX package reads the flag only for int8): the same optimizer and the
    same update as without the flag."""
    rng = np.random.RandomState(5)
    for sd in ("fp32", "bf16", "int8f"):
        with_flag = topt.build_optimizer(TOptCfg(**_opt(sd,
                                                        fused_update=True)))
        plain = topt.build_optimizer(TOptCfg(**_opt(sd)))
        assert with_flag.update_fused is None
        master = {k: _t(v) for k, v in _tree(rng, [(4, 32), ()]).items()}
        g = {k: _t(v) for k, v in _tree(rng, [(4, 32), ()]).items()}
        a = with_flag.update(g, with_flag.init(master), master, 1e-2, 1.0)
        b = plain.update(g, plain.init(master), master, 1e-2, 1.0)
        for k in master:
            assert torch.equal(a[0][k], b[0][k])
            for key in b[1]:
                assert torch.equal(a[1][key][k], b[1][key][k])
    model = TTransformer(tgpt2("tiny", dtype=torch.float32, **TINY))
    eng = dt.initialize(model=model, device="cpu", config={
        "train_micro_batch_size_per_gpu": 2, "steps_per_print": 0,
        "optimizer": _opt("int8f", fused_update=True)})
    assert not eng.fused_update


# ----------------------------------------------------------------------
# the engine against the JAX engine
# ----------------------------------------------------------------------
def _engines(dtype, fused=True, clip=1.0):
    jd = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    jm = JTransformer(jgpt2("tiny", dtype=jd, remat=True, tiled_loss_shards=4,
                            **TINY))
    tm = TTransformer(tgpt2("tiny", dtype=dtype, remat=True,
                            tiled_loss_shards=4, **TINY))
    conf = {"train_micro_batch_size_per_gpu": 1,
            "gradient_accumulation_steps": 1,
            "optimizer": _opt("int8", fused_update=fused),
            "gradient_clipping": clip, "steps_per_print": 0,
            "zero_optimization": {"stage": 1},
            "activation_checkpointing": {"policy": "save_attn"}}
    if dtype == torch.bfloat16:
        conf["bf16"] = {"enabled": True}
        conf["data_types"] = {"grad_accum_dtype": "bf16"}
    je = dstpu.initialize(model=jm, config=conf)
    # the JAX engine's micro-batch spans its 8 virtual devices: the port's
    # engine, on one device, takes that global micro-batch
    tconf = dict(conf, train_micro_batch_size_per_gpu=(
        je.config.train_batch_size))
    start = jax.device_get(je.state.master if je.state.master is not None
                           else je.state.params)
    te = dt.initialize(model=tm, config=tconf, params=start, device="cpu")
    return je, te


def _batches(je, n, seed):
    rng = np.random.RandomState(seed)
    return [{"input_ids": rng.randint(0, TINY["vocab_size"], (
        je.config.train_batch_size, 48)).astype(np.int32)} for _ in range(n)]


def _assert_steps(je, te, batches, tol):
    for batch in batches:
        jmet, tmet = je.train_batch(batch), te.train_batch(batch)
        for key in ("loss", "grad_norm"):
            j, t = float(jmet[key]), float(tmet[key])
            assert abs(t - j) <= tol[key] * abs(j), (key, j, t)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16-master"])
def test_int8_fused_engine_matches_jax(dtype):
    """adamw, int8 moments, fused_update, clip 1.0, 3 steps.  Both engines
    run the plain update on the CPU (the JAX engine takes update_fused on
    a TPU only, the port's on the card only)."""
    je, te = _engines(dtype)
    assert te.optimizer.update_fused is not None and not te.fused_update
    tol = STEP_TOL if dtype == torch.float32 else BF16_STEP_TOL
    _assert_steps(je, te, _batches(je, 3, 0), tol)


def test_engine_continues_from_the_jax_engines_int8_state():
    """Two JAX steps, then the port starts from the JAX master and int8
    state (`opt_state_from_jax` keeps the int8/uint8 codes as codes) and
    both take three more steps."""
    je, te = _engines(torch.float32, clip=0.5)
    for batch in _batches(je, 2, 7):
        je.train_batch(batch)
    state = opt_state_from_jax(jax.device_get(je.state.opt_state), "cpu")
    for key, dtype in (("m", torch.int8), ("v", torch.uint8),
                       ("m_scale", torch.float32),
                       ("v_scale", torch.float32)):
        assert all(t.dtype == dtype for t in state[key]["layers"].values())
    master = jax.device_get(je.state.params)
    te.set_state(int(je.state.step), master=topt.tree_map(
        lambda a: _t(np.asarray(a, np.float32)), master), opt_state=state)
    assert torch.equal(te.opt_state["v"]["layers"]["wq"],
                       _t(np.asarray(je.state.opt_state["v"]["layers"]
                                     ["wq"])))
    _assert_steps(je, te, _batches(je, 3, 8), STEP_TOL)


def test_engine_fused_branch_trains_in_place(monkeypatch):
    """The engine's fused branch (forced here; the wrapper then runs its
    plain version on the CPU tensors) writes master, parameters and state
    into their storage: the same losses and grad norms as the plain
    update, step for step, and the same storage after every step."""
    model = TTransformer(tgpt2("tiny", dtype=torch.bfloat16, remat=True,
                               **TINY))
    conf = {"train_micro_batch_size_per_gpu": 2, "steps_per_print": 0,
            "gradient_clipping": 1.0, "bf16": {"enabled": True},
            "data_types": {"grad_accum_dtype": "bf16"},
            "optimizer": _opt("int8", fused_update=True)}
    plain = dt.initialize(model=model, config=conf, device="cpu")
    fused = dt.initialize(model=model, config=conf, device="cpu")
    monkeypatch.setattr(tengine.TrainEngine, "fused_update",
                        property(lambda self: self is fused))
    ptrs = [t.data_ptr() for t in fused.params["layers"].values()] + [
        fused.master["tok_embed"].data_ptr()]
    rng = np.random.RandomState(9)
    batch = {"input_ids": rng.randint(0, TINY["vocab_size"], (2, 33)
                                      ).astype(np.int32)}
    for _ in range(3):
        a, b = plain.train_batch(batch), fused.train_batch(batch)
        assert float(a["loss"]) == float(b["loss"])
        assert float(a["grad_norm"]) == float(b["grad_norm"])
    assert ptrs == [t.data_ptr() for t in fused.params["layers"].values()] \
        + [fused.master["tok_embed"].data_ptr()]
    for k in plain.params["layers"]:
        assert torch.equal(plain.params["layers"][k],
                           fused.params["layers"][k])
    assert tfa.fused_adam8_leaf.launches == 0   # CPU: no kernel launch
