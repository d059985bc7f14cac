"""The port's dense LM stack against the JAX package, on the CPU.

The same inputs, made from a seed with numpy, go through the JAX function
and its port.  Weights cross over as numpy arrays
(``convert.lm_params_from_numpy``), so the forward comparisons see equal
weights.  Tolerances, each with its reason:

* elementwise blocks (RMSNorm, RoPE, SwiGLU) and the initial weights:
  1e-6, a few float32 roundings;
* float32 logits and loss at a small GQA config: 1e-4, matrix products
  summed in another order over two layers;
* bfloat16 loss: 2e-2, the two frameworks round bf16 at other places;
* serving in float32: tokens equal, exactly.

The flash path runs the JAX package's Pallas kernel in interpret mode and
the port's plain version (``ref.attention_ref``), as on any CPU tensor."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import Model as JModel
from repro.models import layers as jlayers
from repro.serving.engine import Request as JRequest
from repro.serving.engine import ServingEngine as JServingEngine
from repro_torch import convert, random as tr
from repro_torch.configs import get_config
from repro_torch.kernels import flash_attention as fa
from repro_torch.models import Model, layers
from repro_torch.models.params import leaves
from repro_torch.serving.engine import Request, ServingEngine

CPU = "cpu"


def _gqa_cfg(get, dtype="float32"):
    return get("tinyllama-1.1b").smoke().replace(
        dtype=dtype, n_heads=8, n_kv_heads=2, head_dim=16)


def _tiny_cfg(get):
    """``tests/test_trainer.py``'s engine config, in float32."""
    return get("tinyllama-1.1b").smoke().replace(
        n_layers=2, vocab=64, d_model=32, n_heads=2, n_kv_heads=2,
        head_dim=16, d_ff=64, dtype="float32")


def _example_cfg(get):
    """``examples/serve_batched.py``'s config, in float32."""
    return get("tinyllama-1.1b").smoke().replace(
        vocab=512, d_model=128, n_layers=4, n_heads=4, n_kv_heads=2,
        head_dim=32, d_ff=256, dtype="float32")


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _port_params(jparams, cfg):
    return convert.lm_params_from_numpy(jax.tree.map(np.asarray, jparams),
                                        cfg, CPU)


def _tokens(cfg, B, S, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (B, S),
                                                dtype=np.int32)


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------

def test_rms_norm_matches_reference():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32)
    w = rng.standard_normal(64).astype(np.float32)
    want = jlayers.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-5)
    got = layers.rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-5)
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("theta", [10000.0, 500000.0])
def test_rope_matches_reference(theta):
    rng = np.random.default_rng(1)
    pos = rng.integers(0, 4096, (2, 7)).astype(np.int32)
    x = rng.standard_normal((2, 7, 4, 32)).astype(np.float32)
    jc, js = jlayers.rope_cos_sin(jnp.asarray(pos), 32, theta)
    c, s = layers.rope_cos_sin(torch.from_numpy(pos), 32, theta)
    # cos/sin of angles up to ~4e3 rad: 1e-6 of the float32 angle's ulp
    np.testing.assert_allclose(_f32(c), _f32(jc), rtol=0, atol=1e-6)
    np.testing.assert_allclose(_f32(s), _f32(js), rtol=0, atol=1e-6)
    want = jlayers.apply_rope(jnp.asarray(x), jc, js)
    got = layers.apply_rope(torch.from_numpy(x), torch.tensor(_f32(jc)),
                            torch.tensor(_f32(js)))
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=1e-6, atol=1e-6)


def test_swiglu_matches_reference():
    cfg = _gqa_cfg(jget_config)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 5, cfg.d_model)).astype(np.float32)
    w = {n: (rng.standard_normal(s) * 0.1).astype(np.float32)
         for n, s in (("w1", (64, 128)), ("w3", (64, 128)),
                      ("w2", (128, 64)))}
    want = jlayers.swiglu({k: jnp.asarray(v) for k, v in w.items()},
                          jnp.asarray(x))
    got = layers.SwiGLU({k: torch.from_numpy(v) for k, v in w.items()})(
        torch.from_numpy(x))
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("scan_layers", [True, False])
def test_init_params_match_reference(scan_layers):
    """Same key, same weights: the port's threefry normal, leaf by leaf in
    jax's tree order (1e-6: ``random.normal`` is within 7.15e-7)."""
    cfg = _gqa_cfg(get_config).replace(scan_layers=scan_layers)
    jparams = JModel(_gqa_cfg(jget_config).replace(
        scan_layers=scan_layers)).init_params(jax.random.PRNGKey(0))
    port = Model(cfg, CPU)
    params = port.init_params(tr.PRNGKey(0))
    want = jax.tree.leaves(jparams)
    got = leaves(_tree_of(params, cfg))
    assert len(got) == len(want) == len(leaves(port.param_defs()))
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape and g.dtype == torch.float32
        np.testing.assert_allclose(_f32(g), _f32(w), rtol=0, atol=1e-6)


def _tree_of(params, cfg):
    """The module's weights back in the JAX tree's structure: stacked, or
    a list of layers without ``cfg.scan_layers``."""
    def layer(b):
        return {"attn": {n: getattr(b.attn, n) for n in
                         ("wk", "wo", "wq", "wv")},
                "ln1": b.ln1, "ln2": b.ln2,
                "mlp": {n: getattr(b.mlp, n) for n in ("w1", "w2", "w3")}}
    per = [layer(b) for b in params.layers]
    if cfg.scan_layers:
        stacked = {k: ({n: torch.stack([p[k][n] for p in per])
                        for n in per[0][k]}
                       if isinstance(per[0][k], dict)
                       else torch.stack([p[k] for p in per]))
                   for k in per[0]}
    else:
        stacked = per
    return {"embed": {"tok": params.tok}, "head": {"out": params.out},
            "layers": stacked, "ln_f": params.ln_f}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lm_params_from_numpy_round_trip(dtype):
    cfg = _gqa_cfg(get_config, dtype)
    jparams = JModel(_gqa_cfg(jget_config, dtype)).init_params(
        jax.random.PRNGKey(3))
    tree = jax.tree.map(np.asarray, jparams)
    params = convert.lm_params_from_numpy(tree, cfg, CPU)
    back = _tree_of(params, cfg)
    for g, w in zip(leaves(back), jax.tree.leaves(tree)):
        assert g.dtype == getattr(torch, dtype)
        np.testing.assert_array_equal(_f32(g), w.astype(np.float32))
    # per-layer weights are views of the stacked leaves: nothing copied
    assert params.layers[1].attn.wq.data_ptr() == \
        params.layers[0].attn.wq.data_ptr() + params.layers[0].attn.wq.nbytes


# ---------------------------------------------------------------------------
# forward and loss
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def gqa_f32():
    jcfg = _gqa_cfg(jget_config)
    jparams = JModel(jcfg).init_params(jax.random.PRNGKey(0))
    toks = _tokens(jcfg, 2, 128, seed=1)
    labels = _tokens(jcfg, 2, 128, seed=2)
    return jcfg, jparams, toks, labels


@pytest.mark.parametrize("impl", ["einsum", "flash"])
def test_forward_and_loss_match_reference_f32(gqa_f32, impl):
    jcfg, jparams, toks, labels = gqa_f32
    jm = JModel(jcfg.replace(attn_impl=impl))
    jb = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}
    jlogits = jax.jit(lambda p, b: jm.forward(p, b).logits)(jparams, jb)
    jloss = jax.jit(jm.loss)(jparams, jb)

    cfg = _gqa_cfg(get_config).replace(attn_impl=impl)
    params = _port_params(jparams, cfg)
    m = Model(cfg, CPU)
    b = {"tokens": torch.from_numpy(toks), "labels": torch.from_numpy(labels)}
    fa.reset_launches()
    logits = m.forward(params, b).logits
    loss = m.loss(params, b)
    assert fa.LAUNCHES["flash_attention"] == 0     # CPU: plain version
    np.testing.assert_allclose(_f32(logits), _f32(jlogits), rtol=0,
                               atol=1e-4)
    assert abs(float(loss) - float(jloss)) < 1e-4


@pytest.mark.parametrize("impl", ["einsum", "flash"])
def test_loss_matches_reference_bf16(impl):
    jcfg = _gqa_cfg(jget_config, "bfloat16").replace(attn_impl=impl)
    jparams = JModel(jcfg).init_params(jax.random.PRNGKey(0))
    toks = _tokens(jcfg, 2, 128, seed=4)
    jloss = jax.jit(JModel(jcfg).loss)(
        jparams, {"tokens": jnp.asarray(toks), "labels": jnp.asarray(toks)})
    cfg = _gqa_cfg(get_config, "bfloat16").replace(attn_impl=impl)
    loss = Model(cfg, CPU).loss(
        _port_params(jparams, cfg),
        {"tokens": torch.from_numpy(toks), "labels": torch.from_numpy(toks)})
    assert abs(float(loss) - float(jloss)) < 2e-2


def test_prefill_decode_matches_full_forward():
    """prefill(t[:k]) + decode(t[k]) logits == full forward logits at k,
    in the port and against the reference's full forward (1e-4, f32)."""
    jcfg = jget_config("tinyllama-1.1b").smoke().replace(dtype="float32")
    jparams = JModel(jcfg).init_params(jax.random.PRNGKey(0))
    cfg = get_config("tinyllama-1.1b").smoke().replace(dtype="float32")
    params = _port_params(jparams, cfg)
    m = Model(cfg, CPU)
    B, S = 2, 16
    toks = torch.from_numpy(_tokens(cfg, B, S + 1, seed=5))

    full = m.forward(params, {"tokens": toks}).logits
    cache = m.init_cache(B, S + 1)
    _, cache = m.prefill(params, {"tokens": toks[:, :S]}, cache)
    assert cache["pos"] == S
    dec = m.forward(params, {"tokens": toks[:, S:S + 1]}, cache=cache)
    np.testing.assert_allclose(_f32(dec.logits[:, 0]), _f32(full[:, S]),
                               rtol=0, atol=1e-4)
    jfull = JModel(jcfg).forward(jparams, {"tokens": jnp.asarray(
        toks.numpy())}).logits
    np.testing.assert_allclose(_f32(dec.logits[:, 0]), _f32(jfull[:, S]),
                               rtol=0, atol=1e-4)


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def _prompts(cfg, n, lo, hi, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, cfg.vocab, size=int(rng.integers(lo, hi)),
                         dtype=np.int32) for _ in range(n)]


@pytest.mark.parametrize("which,max_batch,max_len,n,max_new", [
    ("tiny", 2, 32, 3, 6),
    ("example", 4, 128, 6, 16),
])
def test_serving_engine_matches_reference(which, max_batch, max_len, n,
                                          max_new):
    make = {"tiny": _tiny_cfg, "example": _example_cfg}[which]
    jcfg, cfg = make(jget_config), make(get_config)
    jmodel = JModel(jcfg)
    jparams = jmodel.init_params(jax.random.PRNGKey(0))
    prompts = _prompts(cfg, n, 2, 12, seed=7)
    want = JServingEngine(jmodel, jparams, max_batch, max_len).run(
        [JRequest(i, p, max_new=max_new) for i, p in enumerate(prompts)])

    model = Model(cfg, CPU)
    eng = ServingEngine(model, _port_params(jparams, cfg), max_batch, max_len)
    fa.reset_launches()
    got = eng.run([Request(i, p, max_new=max_new)
                   for i, p in enumerate(prompts)])
    assert got == want
    assert sorted(got) == list(range(n))
    assert fa.LAUNCHES["flash_attention"] == 0


def test_serving_engine_matches_sequential_decode():
    """The engine's tokens equal one-by-one greedy decoding in the port."""
    cfg = _tiny_cfg(get_config)
    model = Model(cfg, CPU)
    params = model.init_params(tr.PRNGKey(0))
    prompts = _prompts(cfg, 3, 2, 6, seed=8)
    out = ServingEngine(model, params, max_batch=2, max_len=32).run(
        [Request(i, p, max_new=6) for i, p in enumerate(prompts)])
    for i, p in enumerate(prompts):
        cache = model.init_cache(1, 32)
        logits, cache = model.prefill(
            params, {"tokens": torch.from_numpy(p)[None]}, cache)
        seq = [int(torch.argmax(logits[0].float()))]
        pos = len(p)
        for _ in range(5):
            nxt, cache = model.decode_step(
                params, {"tokens": torch.tensor([[seq[-1]]]),
                         "positions": torch.tensor([[pos]])}, cache)
            seq.append(int(nxt[0]))
            pos += 1
        assert out[i] == seq, (i, out[i], seq)
