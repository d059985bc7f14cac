"""The port's int8 gradient compression against the JAX package's:
``compress_tree`` bit for bit on seeded numpy gradients (with a carried
error buffer), and the reference's convergence test mirrored.  The
compressed all-reduce over four ranks is in ``test_torch_mesh.py``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.distributed import compression as rcomp
from repro_torch.distributed import compression as comp


def _grads(seed: int):
    r = np.random.default_rng(seed)
    return {"w": r.normal(0, 1, (64, 64)).astype(np.float32),
            "nested": {"b": r.normal(0, 1e-3, (7,)).astype(np.float32),
                       "big": (r.normal(0, 50, (3, 5, 4))
                               .astype(np.float32))},
            "zero": np.zeros((4,), np.float32)}


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    return np.asarray(tree)


def _walk(a, b):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            _walk(a[k], b[k])
        return
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


def _t(tree):
    if isinstance(tree, dict):
        return {k: _t(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def _j(tree):
    if isinstance(tree, dict):
        return {k: _j(v) for k, v in tree.items()}
    return jnp.asarray(tree)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_compress_tree_bit_equal(seed):
    g1, g2 = _grads(seed), _grads(seed + 100)
    e, re = comp.init_error_buffer(_t(g1)), rcomp.init_error_buffer(_j(g1))
    for g in (g1, g2):      # the second round carries the residual
        q, s, e = comp.compress_tree(_t(g), e)
        rq, rs, re = rcomp.compress_tree(_j(g), re)
        _walk(_tree_np(q), _np(rq))
        _walk(_tree_np(s), _np(rs))
        _walk(_tree_np(e), _np(re))
        assert _tree_np(q)["w"].dtype == np.int8


def _tree_np(tree):
    if isinstance(tree, dict):
        return {k: _tree_np(v) for k, v in tree.items()}
    return tree.numpy()


def test_quantize_error_bound_and_residual():
    """The reference's ``test_int8_quantization_error_feedback``."""
    r = np.random.default_rng(0)
    g = {"w": torch.from_numpy(r.normal(0, 1, (64, 64)).astype(np.float32))}
    q, s, e2 = comp.compress_tree(g, comp.init_error_buffer(g))
    deq = q["w"].numpy().astype(np.float32) * float(s["w"])
    rel = np.abs(deq - g["w"].numpy()).max() / np.abs(g["w"].numpy()).max()
    assert rel < 0.02
    np.testing.assert_allclose(e2["w"].numpy(), g["w"].numpy() - deq,
                               rtol=1e-5, atol=1e-6)


def test_compression_convergence():
    """SGD on a quadratic with compressed gradients converges (error
    feedback), as the reference's test; both packages' iterates agree."""
    r = np.random.default_rng(0)
    w0 = r.normal(0, 1, (16,)).astype(np.float32)
    target = r.normal(0, 1, (16,)).astype(np.float32)
    w, rw = torch.from_numpy(w0.copy()), jnp.asarray(w0)
    t, rt = torch.from_numpy(target), jnp.asarray(target)
    e = comp.init_error_buffer({"w": w})
    re = rcomp.init_error_buffer({"w": rw})
    for _ in range(300):
        q, s, e = comp.compress_tree({"w": w - t}, e)
        w = w - 0.1 * (q["w"].to(torch.float32) * s["w"])
        rq, rs, re = rcomp.compress_tree({"w": rw - rt}, re)
        rw = rw - 0.1 * (rq["w"].astype(jnp.float32) * rs["w"])
    assert float((w - t).abs().max()) < 1e-2
    np.testing.assert_allclose(w.numpy(), np.asarray(rw), rtol=0,
                               atol=1e-6)
