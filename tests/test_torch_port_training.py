"""The PyTorch port's training slice against the JAX package, on the CPU.

Inputs are drawn with numpy from fixed seeds and fed to both sides; the
port runs its kernels' plain versions (CPU tensors), the JAX side its
Pallas kernels in interpret mode where it reaches them.  Covered, each
with its tolerance and the reason for it:

- the flash backward (plain dq and dk/dv) against `jax.grad` of the JAX
  `flash_attention`, and the port's autograd path against autograd
  through `flash_attention_reference`;
- the int8f codec and one optimizer update (adamw fp32 / bf16 / int8f,
  sgd) against the JAX `build_optimizer(...).update`, codes bit for bit;
- `tiled_fused_logits_loss` value and gradients; every LR schedule;
- the engine against the JAX engine step for step (gpt2 and llama tiny,
  f32: sgd, adamw, adamw-int8f, gas 2, clipping, both label branches of
  `_lm_loss`, and a start from the JAX engine's state after two steps),
  plus a bf16 case with a looser bound;
- the remat policies (identical losses; flash forward runs per step);
- the refusals of what the slice does not carry.

The JAX engine runs on the test harness's 8 virtual devices (dp = 8), so
its micro-batch is 8 times the configured one: the port's engine, on one
device, is configured with that global micro-batch, which is the same
mean loss over the same rows.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu as dstpu
from deepspeed_tpu.config.config import OptimizerConfig as JOptCfg
from deepspeed_tpu.config.config import SchedulerConfig as JSchedCfg
from deepspeed_tpu.models import Transformer as JTransformer
from deepspeed_tpu.models import gpt2_config as jgpt2
from deepspeed_tpu.models import llama_config as jllama
from deepspeed_tpu.ops import flash_attention as jflash
from deepspeed_tpu.runtime import lr_schedules as jlr
from deepspeed_tpu.runtime import optimizers as jopt
from deepspeed_tpu.sequence.tiled import tiled_fused_logits_loss as jtiled

import deepspeed_tpu_torch as dt
from deepspeed_tpu_torch.config.config import ConfigError
from deepspeed_tpu_torch.config.config import OptimizerConfig as TOptCfg
from deepspeed_tpu_torch.config.config import SchedulerConfig as TSchedCfg
from deepspeed_tpu_torch.models import Transformer as TTransformer
from deepspeed_tpu_torch.models import gpt2_config as tgpt2
from deepspeed_tpu_torch.models import llama_config as tllama
from deepspeed_tpu_torch.models import opt_state_from_jax
from deepspeed_tpu_torch.ops import flash_attention as tflash
from deepspeed_tpu_torch.runtime import lr_schedules as tlr
from deepspeed_tpu_torch.runtime import optimizers as topt
from deepspeed_tpu_torch.sequence.tiled import (
    tiled_fused_logits_loss as ttiled)

pytestmark = pytest.mark.kernels

# f32 on both sides, the same math in another summation order (and, for
# the Pallas kernel, a blockwise online softmax): a few f32 ulps of
# outputs of size ~1-10
GRAD_TOL = dict(rtol=1e-5, atol=1e-5)
# whole f32 training steps: losses agree to ~5e-7 and grad norms to
# ~1.5e-5 relative over 5 AdamW steps (the norms are sums over every
# gradient element, and AdamW's m/sqrt(v) amplifies ulp-level gradient
# differences of near-zero entries); 1e-5 / 1e-4 bound them
STEP_TOL = dict(loss=1e-5, grad_norm=1e-4)
# bf16 compute: bf16 rounds at other places in the two frameworks (XLA
# fuses the f32 elementwise chains of norm/gelu; PyTorch rounds between
# ops), measured 7e-5 (loss) and 3e-3 (grad norm) relative over 5 steps
BF16_STEP_TOL = dict(loss=1e-3, grad_norm=2e-2)

TINY = dict(hidden_size=64, num_heads=2, num_layers=2, max_seq_len=64,
            vocab_size=256)


@pytest.fixture
def _interpret_mode(monkeypatch):
    import jax.experimental.pallas as pl
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))


def _t(a):
    return torch.from_numpy(np.array(a))


# ----------------------------------------------------------------------
# flash backward
# ----------------------------------------------------------------------
@pytest.mark.parametrize("B,S,NH,NKV,D", [(2, 256, 4, 4, 64),
                                          (1, 256, 8, 2, 128)],
                         ids=["mha-d64", "gqa-d128"])
def test_plain_backward_matches_pallas_backward(_interpret_mode, B, S, NH,
                                                NKV, D):
    rng = np.random.RandomState(0)
    q = rng.randn(B, S, NH, D).astype(np.float32)
    k = rng.randn(B, S, NKV, D).astype(np.float32)
    v = rng.randn(B, S, NKV, D).astype(np.float32)
    do = rng.randn(B, S, NH, D).astype(np.float32)

    def f(q, k, v):
        out = jflash.flash_attention(q, k, v, causal=True, block_q=128,
                                     block_k=128)
        return jnp.sum(out * do)

    want = jax.grad(f, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k),
                                          jnp.asarray(v))
    out, lse = tflash.flash_attention_reference(_t(q), _t(k), _t(v))
    dq = tflash.flash_attention_bwd_dq(_t(q), _t(k), _t(v), out, lse,
                                       _t(do))
    dk, dv = tflash.flash_attention_bwd_dkv(_t(q), _t(k), _t(v), out, lse,
                                            _t(do))
    for got, ref in zip((dq, dk, dv), want):
        assert got.shape == ref.shape
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), **GRAD_TOL)


@pytest.mark.parametrize("NKV", [4, 2], ids=["mha", "gqa"])
def test_autograd_path_matches_autograd_through_the_reference(NKV):
    rng = np.random.RandomState(1)
    B, S, NH, D = 2, 37, 4, 32
    arrs = [rng.randn(B, S, n, D).astype(np.float32)
            for n in (NH, NKV, NKV)]
    do = _t(rng.randn(B, S, NH, D).astype(np.float32))
    mine = [_t(a).requires_grad_() for a in arrs]
    ref = [_t(a).requires_grad_() for a in arrs]
    out = tflash.flash_attention(*mine)
    assert out.grad_fn is not None
    (out * do).sum().backward()
    (tflash.flash_attention_reference(*ref)[0] * do).sum().backward()
    for a, b in zip(mine, ref):
        np.testing.assert_allclose(a.grad.numpy(), b.grad.numpy(),
                                   **GRAD_TOL)


def test_serving_calls_pay_nothing_for_autograd():
    q = torch.randn(1, 8, 2, 32)
    out = tflash.flash_attention(q, q, q)
    assert out.grad_fn is None
    with torch.no_grad():
        assert tflash.flash_attention(q.requires_grad_(), q, q).grad_fn \
            is None


# ----------------------------------------------------------------------
# optimizers
# ----------------------------------------------------------------------
def test_int8f_codec_matches_jax_bit_for_bit():
    rng = np.random.RandomState(2)
    x = (rng.randn(16, 64) * np.exp(rng.randn(16, 1) * 3)).astype(
        np.float32)
    x[0] = 0.0
    bound = np.abs(x).max(-1, keepdims=True) * rng.uniform(
        0.5, 2.0, (16, 1)).astype(np.float32)
    bound[1] = 0.0
    xs, bs = jnp.asarray(x), jnp.asarray(bound)
    qs = np.asarray(jopt._q8_sq_signed(xs, bs))
    np.testing.assert_array_equal(
        topt._q8_sq_signed(_t(x), _t(bound)).numpy(), qs)
    qv = np.asarray(jopt._q8_sq(jnp.abs(xs), bs))
    np.testing.assert_array_equal(
        topt._q8_sq(_t(np.abs(x)), _t(bound)).numpy(), qv)
    np.testing.assert_array_equal(
        topt._dq8_sq_signed(_t(qs), _t(bound)).numpy(),
        np.asarray(jopt._dq8_sq_signed(jnp.asarray(qs), bs)))
    np.testing.assert_array_equal(
        topt._dq8_sq(_t(qv), _t(bound)).numpy(),
        np.asarray(jopt._dq8_sq(jnp.asarray(qv), bs)))


def _opt_tree(rng):
    return {"w": rng.randn(8, 64).astype(np.float32),
            "layers": {"b": rng.randn(3, 16).astype(np.float32)},
            "s": np.asarray(rng.randn(), np.float32)}


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.float().numpy() if tree.is_floating_point() \
            else tree.numpy()
    return np.asarray(tree.astype(jnp.float32) if tree.dtype == jnp.bfloat16
                      else tree)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [tree]


@pytest.mark.parametrize("state_dtype", ["fp32", "bf16", "int8f"])
def test_adamw_update_matches_jax(state_dtype):
    """Two updates from the initial state, with a folded grad_scale:
    masters within f32 rounding, moments equal (int8f codes and scales
    bit for bit)."""
    rng = np.random.RandomState(3)
    params = {"type": "adamw", "params": {"lr": 1e-2, "weight_decay": 0.1,
                                          "state_dtype": state_dtype}}
    jo = jopt.build_optimizer(JOptCfg(**params))
    to = topt.build_optimizer(TOptCfg(**params))
    master = _opt_tree(rng)
    jm = jax.tree.map(jnp.asarray, master)
    tm = {"w": _t(master["w"]), "layers": {"b": _t(master["layers"]["b"])},
          "s": _t(master["s"])}
    js, ts = jo.init(jm), to.init(tm)
    for step in (1, 2):
        g = _opt_tree(rng)
        jm, js = jo.update(jax.tree.map(jnp.asarray, g), js, jm, 1e-2,
                           jnp.float32(step), grad_scale=jnp.float32(0.5))
        tm, ts = to.update(
            {"w": _t(g["w"]), "layers": {"b": _t(g["layers"]["b"])},
             "s": _t(g["s"])}, ts, tm, 1e-2, float(step),
            grad_scale=torch.tensor(0.5))
    # the port takes the bias corrections in Python floats, JAX as f32
    # pows: masters of size ~1 moved by lr 1e-2 differ in the last bits
    for a, b in zip(_leaves(_np(tm)), _leaves(_np(jm))):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6)
    for key in js:
        for a, b in zip(_leaves(_np(ts[key])), _leaves(_np(js[key]))):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


def test_sgd_momentum_update_matches_jax():
    rng = np.random.RandomState(4)
    params = {"type": "sgd", "params": {"lr": 0.1, "momentum": 0.9,
                                        "weight_decay": 0.01}}
    jo = jopt.build_optimizer(JOptCfg(**params))
    to = topt.build_optimizer(TOptCfg(**params))
    master = {"w": rng.randn(4, 8).astype(np.float32)}
    jm, tm = {"w": jnp.asarray(master["w"])}, {"w": _t(master["w"])}
    js, ts = jo.init(jm), to.init(tm)
    for step in (1, 2):
        g = rng.randn(4, 8).astype(np.float32)
        jm, js = jo.update({"w": jnp.asarray(g)}, js, jm, 0.1, step)
        tm, ts = to.update({"w": _t(g)}, ts, tm, 0.1, step)
    np.testing.assert_allclose(tm["w"].numpy(), np.asarray(jm["w"]),
                               rtol=1e-6, atol=1e-7)


# ----------------------------------------------------------------------
# tiled loss, LR schedules
# ----------------------------------------------------------------------
def test_tiled_loss_matches_jax():
    rng = np.random.RandomState(5)
    B, S, H, V = 2, 32, 16, 40
    x = rng.randn(B, S, H).astype(np.float32)
    head = (rng.randn(H, V) * 0.3).astype(np.float32)
    bias = rng.randn(V).astype(np.float32)
    labels = rng.randint(0, V, (B, S)).astype(np.int32)
    mask = (rng.rand(B, S) > 0.2).astype(np.int32)

    def jloss(x, head, bias):
        return jtiled(x, head, jnp.asarray(labels), shards=4,
                      mask=jnp.asarray(mask), bias=bias)

    jval, jgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2))(
        jnp.asarray(x), jnp.asarray(head), jnp.asarray(bias))
    tx, th, tb = (_t(a).requires_grad_() for a in (x, head, bias))
    tval = ttiled(tx, th, _t(labels), shards=4, mask=_t(mask), bias=tb)
    tval.backward()
    np.testing.assert_allclose(float(tval.detach()), float(jval), rtol=1e-6)
    for got, ref in zip((tx, th, tb), jgrads):
        np.testing.assert_allclose(got.grad.numpy(), np.asarray(ref),
                                   rtol=1e-5, atol=1e-7)
    with pytest.raises(ValueError, match="not divisible"):
        ttiled(tx, th, _t(labels), shards=5)


@pytest.mark.parametrize("kind,params", [
    ("WarmupLR", {"warmup_min_lr": 1e-5, "warmup_max_lr": 1e-3,
                  "warmup_num_steps": 20}),
    ("WarmupLR", {"warmup_num_steps": 20, "warmup_type": "linear"}),
    ("WarmupDecayLR", {"warmup_num_steps": 10, "total_num_steps": 40}),
    ("WarmupCosineLR", {"warmup_num_steps": 10, "total_num_steps": 40,
                        "warmup_min_ratio": 0.1}),
    ("OneCycle", {"cycle_first_step_size": 15, "cycle_second_step_size": 10,
                  "decay_lr_rate": 0.05}),
    ("LRRangeTest", {"lr_range_test_step_size": 7,
                     "lr_range_test_staircase": True}),
    ("constant", {})])
def test_lr_schedules_match_jax(kind, params):
    jf = jlr.build_scheduler(JSchedCfg(type=kind, params=params), 3e-4)
    tf = tlr.build_scheduler(TSchedCfg(type=kind, params=params), 3e-4)
    got = [tf(s) for s in range(50)]
    want = [float(jf(jnp.int32(s))) for s in range(50)]
    # JAX evaluates in f32, the port in Python floats; f32 loses a few
    # more digits to cancellation where a cosine nears its floor
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-12)


# ----------------------------------------------------------------------
# the engine against the JAX engine
# ----------------------------------------------------------------------
def _configs(family, dtype, **kw):
    jcfg, tcfg = (jgpt2, tgpt2) if family == "gpt2" else (jllama, tllama)
    arch = dict(TINY, **({"num_kv_heads": 1} if family == "llama" else {}))
    arch.update(kw)
    jd = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    return (JTransformer(jcfg("tiny", dtype=jd, **arch)),
            TTransformer(tcfg("tiny", dtype=dtype, **arch)))


def _engines(family, opt, gas=2, clip=1.0, policy="save_attn",
             dtype=torch.float32, **model_kw):
    jm, tm = _configs(family, dtype, remat=True, tiled_loss_shards=4,
                      **model_kw)
    conf = {"train_micro_batch_size_per_gpu": 1,
            "gradient_accumulation_steps": gas, "optimizer": opt,
            "gradient_clipping": clip, "steps_per_print": 0,
            "zero_optimization": {"stage": 1},
            "activation_checkpointing": {"policy": policy}}
    if dtype == torch.bfloat16:
        conf["bf16"] = {"enabled": True}
        conf["data_types"] = {"grad_accum_dtype": "bf16"}
    je = dstpu.initialize(model=jm, config=conf)
    # the JAX engine's micro-batch spans its 8 devices (module docstring)
    tconf = dict(conf, train_micro_batch_size_per_gpu=(
        je.config.train_batch_size // gas))
    start = jax.device_get(je.state.master if je.state.master is not None
                           else je.state.params)
    te = dt.initialize(model=tm, config=tconf, params=start, device="cpu")
    return je, te


def _run(je, te, steps, seq, seed=0, tol=STEP_TOL):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(steps):
        batch = {"input_ids": rng.randint(
            0, TINY["vocab_size"], (je.config.train_batch_size, seq)
        ).astype(np.int32)}
        jmet, tmet = je.train_batch(batch), te.train_batch(batch)
        out.append({k: (float(jmet[k]), float(tmet[k]))
                    for k in ("loss", "grad_norm", "lr")})
        np.testing.assert_allclose(np.asarray(tmet["micro_losses"]),
                                   np.asarray(jmet["micro_losses"]),
                                   rtol=tol["loss"])
    return out


def _assert_steps(out, tol):
    for step in out:
        for key in ("loss", "grad_norm"):
            j, t = step[key]
            assert abs(t - j) <= tol[key] * abs(j), (key, out)
        assert step["lr"][0] == pytest.approx(step["lr"][1], rel=1e-6)


ADAMW = {"type": "adamw", "params": {"lr": 1e-2, "weight_decay": 0.1}}
INT8F = {"type": "adamw", "params": {"lr": 1e-2, "weight_decay": 0.1,
                                     "state_dtype": "int8f"}}
SGD = {"type": "sgd", "params": {"lr": 0.05}}


@pytest.mark.parametrize("family,opt,seq", [
    ("gpt2", SGD, 48), ("gpt2", ADAMW, 48), ("llama", SGD, 48),
    ("llama", ADAMW, 48), ("llama", INT8F, 48),
    ("gpt2", INT8F, TINY["max_seq_len"] + 1)],
    ids=["gpt2-sgd", "gpt2-adamw", "llama-sgd", "llama-adamw",
         "llama-int8f", "gpt2-int8f-seq+1"])
def test_engine_matches_jax_step_for_step(family, opt, seq):
    """f32, gas 2, clip 1.0, 5 steps.  seq 48 <= max_seq_len takes the
    masked-last-position label branch; seq max_seq_len + 1 the sliced
    one."""
    je, te = _engines(family, opt)
    _assert_steps(_run(je, te, 5, seq), STEP_TOL)


def test_engine_continues_from_the_jax_engines_state():
    """Two JAX steps, then the port starts from the JAX master and int8f
    state (`opt_state_from_jax`) and both take three more steps."""
    je, te = _engines("llama", INT8F, gas=1, clip=0.5)
    rng = np.random.RandomState(7)
    for _ in range(2):
        je.train_batch({"input_ids": rng.randint(
            0, TINY["vocab_size"], (je.config.train_batch_size, 48)
        ).astype(np.int32)})
    te.set_state(int(je.state.step), master=_tree_t(jax.device_get(
        je.state.params)), opt_state=opt_state_from_jax(
            jax.device_get(je.state.opt_state), "cpu"))
    _assert_steps(_run(je, te, 3, 48, seed=8), STEP_TOL)


def _tree_t(tree):
    if isinstance(tree, dict):
        return {k: _tree_t(v) for k, v in tree.items()}
    return _t(np.asarray(tree, np.float32))


def test_bf16_engine_matches_jax_within_a_looser_bound():
    je, te = _engines("gpt2", INT8F, gas=1, dtype=torch.bfloat16)
    _assert_steps(_run(je, te, 5, 48, tol=BF16_STEP_TOL), BF16_STEP_TOL)


# ----------------------------------------------------------------------
# remat policies
# ----------------------------------------------------------------------
def test_remat_policies_give_identical_losses(monkeypatch):
    """save_attn keeps the flash op's out and lse (one forward per layer
    per step), nothing_saveable and the config default "none" recompute
    it (two), remat=False saves everything (one); the losses are the
    same."""
    calls = {"n": 0}
    ref = tflash.flash_attention_reference

    def counting(*a, **kw):
        calls["n"] += 1
        return ref(*a, **kw)

    monkeypatch.setattr(tflash, "flash_attention_reference", counting)
    rng = np.random.RandomState(9)
    batch = {"input_ids": rng.randint(0, TINY["vocab_size"], (2, 32)
                                      ).astype(np.int32)}
    L = TINY["num_layers"]
    results = {}
    for name, remat, policy, per_step in (
            ("save_attn", True, "save_attn", L),
            ("nothing_saveable", True, "nothing_saveable", 2 * L),
            ("none", True, "none", 2 * L),
            ("no-remat", False, "none", L)):
        model = TTransformer(tgpt2("tiny", dtype=torch.float32, remat=remat,
                                   **TINY))
        eng = dt.initialize(model=model, device="cpu", config={
            "train_micro_batch_size_per_gpu": 2, "steps_per_print": 0,
            "optimizer": ADAMW,
            "activation_checkpointing": {"policy": policy}})
        losses = []
        for _ in range(3):
            calls["n"] = 0
            losses.append(float(eng.train_batch(batch)["loss"]))
            assert calls["n"] == per_step, name
        results[name] = losses
    assert len({tuple(v) for v in results.values()}) == 1, results


# ----------------------------------------------------------------------
# scope: what the slice does not carry is refused by name
# ----------------------------------------------------------------------
BASE = {"train_micro_batch_size_per_gpu": 2}


@pytest.mark.parametrize("extra,match", [
    ({"fp16": {"enabled": True}}, "fp16"),
    ({"tensor_parallel": {"tp_size": 2}}, "tensor_parallel"),
    ({"zero_optimization": {"stage": 2, "offload_optimizer": {}}},
     "offload_optimizer"),
    ({"optimizer": {"type": "lamb", "params": {}}}, "lamb"),
    ({"optimizer": {"type": "lion", "params": {}}}, "lion"),
    ({"optimizer": {"type": "onebitadam", "params": {}}}, "onebitadam"),
    ({"activation_checkpointing": {"policy": "dots_saveable"}},
     "dots_saveable")])
def test_config_refuses_what_is_not_ported(extra, match):
    model = TTransformer(tgpt2("tiny", dtype=torch.float32, **TINY))
    with pytest.raises(NotImplementedError, match=match):
        dt.initialize(model=model, config=dict(BASE, **extra), device="cpu")


def test_config_refuses_more_than_one_device_and_bad_batches():
    from deepspeed_tpu_torch.config.config import DeepSpeedTPUConfig
    with pytest.raises(NotImplementedError, match="world_size"):
        DeepSpeedTPUConfig.from_json(BASE, world_size=2)
    with pytest.raises(ConfigError, match="train_batch_size"):
        DeepSpeedTPUConfig.from_json({"train_batch_size": 5,
                                      "train_micro_batch_size_per_gpu": 2,
                                      "gradient_accumulation_steps": 2})
    cfg = DeepSpeedTPUConfig.from_json({"train_batch_size": 8,
                                        "gradient_accumulation_steps": 2})
    assert cfg.train_micro_batch_size_per_gpu == 4


@pytest.mark.parametrize("kw,match", [({"dropout": 0.1}, "dropout"),
                                      ({"tiled_mlp_shards": 2},
                                       "tiled_mlp_shards")])
def test_model_config_refuses_what_is_not_ported(kw, match):
    with pytest.raises(NotImplementedError, match=match):
        tgpt2("tiny", **kw)


def test_engine_defaults_to_the_card_and_checks_the_batch(monkeypatch):
    model = TTransformer(tgpt2("tiny", dtype=torch.float32, **TINY))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dt.initialize(model=model, config=BASE)
    eng = dt.initialize(model=model, config=BASE, device="cpu")
    with pytest.raises(ValueError, match="train_batch_size"):
        eng.train_batch({"input_ids": np.zeros((3, 16), np.int32)})
    with pytest.raises(ValueError, match="plain_kernels"):
        dt.initialize(loss_fn=model.loss_fn, params={}, config=BASE,
                      device="cpu", plain_kernels=True)


def test_plain_kernels_selects_the_plain_versions_in_both_engines(
        monkeypatch):
    """`plain_kernels=True` sets the model config's attn_impl to "jnp" in
    the serving and the training engine, and then neither calls a kernel
    wrapper (each raises here)."""
    from deepspeed_tpu_torch.inference.v2 import InferenceEngineV2
    from deepspeed_tpu_torch.inference.v2 import ragged_ops

    def refuse(*args, **kwargs):
        raise AssertionError("a kernel wrapper was called")

    for mod, name in ((tflash, "flash_attention_fwd"),
                      (tflash, "flash_attention_bwd_dq"),
                      (tflash, "flash_attention_bwd_dkv"),
                      (ragged_ops, "paged_decode_attention"),
                      (ragged_ops, "paged_prefill_attention")):
        monkeypatch.setattr(mod, name, refuse)
    cfg = tgpt2("tiny", dtype=torch.float32, remat=True, **TINY)
    serving = InferenceEngineV2(cfg, device="cpu", plain_kernels=True)
    assert serving.cfg.attn_impl == "jnp"
    outs = serving.generate_batch([np.arange(1, 40, dtype=np.int32),
                                   np.arange(3, 9, dtype=np.int32)],
                                  max_new_tokens=3)
    assert [o.shape for o in outs] == [(3,), (3,)]
    eng = dt.initialize(model=TTransformer(cfg), config=BASE, device="cpu",
                        plain_kernels=True)
    loss = eng.train_batch({"input_ids": np.ones((2, 16), np.int32)})["loss"]
    assert np.isfinite(float(loss))
    with pytest.raises(ValueError, match="attn_impl"):
        tgpt2("tiny", attn_impl="pallas")


def test_num_params_matches_jax():
    assert TTransformer(tgpt2("1.3b")).num_params() == \
        JTransformer(jgpt2("1.3b")).num_params()
