"""Ring attention of the port (videopainter_tpu_torch/parallel/ring_attention.py)
against the JAX package's (videopainter_tpu/parallel/ring_attention.py) on
the same numpy inputs, on the CPU.

The port's ranks are processes (`parallel.launch.run_local`, gloo, each call
with its own timeout); the JAX side runs on the virtual CPU devices of
tests/conftest.py, each reference as one jitted program. Tolerances: the JAX
ring tests' (outputs 2e-5; gradients rtol 1e-4, atol 1e-5).
"""

import numpy as np
import pytest

from videopainter_tpu_torch.parallel import run_local, workers

OUT_TOL = dict(rtol=2e-5, atol=2e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)


def _qkv(seed, b, h, s, d):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, h, s, d)).astype(np.float32) for _ in range(4)]


def _jax_joint(q, k, v, dout, st, n):
    """The JAX ring on an n-device seq mesh: (out, grads of q, k, v) of the
    loss <out, dout> over the joint sequence; one jitted program."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from videopainter_tpu.parallel.ring_attention import ring_attention, ring_joint_attention

    mesh = Mesh(np.array(jax.devices()[:n]).reshape(1, n, 1), ("data", "seq", "model"))

    def out_fn(q, k, v):
        if st == 0:
            return ring_attention(q, k, v, mesh)
        t, o = ring_joint_attention(q[:, :, :st], q[:, :, st:], k[:, :, :st], k[:, :, st:],
                                    v[:, :, :st], v[:, :, st:], mesh)
        return jnp.concatenate([t, o], axis=2)

    def f(q, k, v, dout):
        out, vjp = jax.vjp(out_fn, q, k, v)
        return out, vjp(dout)

    with mesh:
        out, grads = jax.jit(f)(q, k, v, dout)
    return np.asarray(out), [np.asarray(g) for g in grads]


def test_ring_joint_and_plain_world4_match_jax():
    """World 4 over gloo: `ring_joint_attention` (text 5 tokens, video 64) and
    `ring_attention` (64 tokens), outputs and the gradients of <out, dout>
    (each rank's share of the text gradients summed over the ranks) against
    the JAX ring with autodiff through ppermute."""
    n, st, sv = 4, 5, 64
    q, k, v, dout = _qkv(0, 1, 2, st + sv, 16)
    q2, k2, v2, d2 = _qkv(1, 2, 4, 32, 8)
    specs = [("ring_rank", {"mesh": (1, n, 1), "q": q, "k": k, "v": v, "dout": dout,
                            "text_len": st}),
             ("ring_rank", {"mesh": (1, n, 1), "q": q2, "k": k2, "v": v2, "dout": d2,
                            "text_len": 0})]
    res = run_local(n, workers.cases_rank, specs, timeout=120)
    for case, (qq, kk, vv, dd, t) in enumerate([(q, k, v, dout, st), (q2, k2, v2, d2, 0)]):
        out, grads = _jax_joint(qq, kk, vv, dd, t, n)
        ranks = [r[case] for r in res]
        if t:
            for r in ranks:   # the text output is the same on every rank
                np.testing.assert_allclose(r["out_text"], out[:, :, :t], **OUT_TOL)
        for r in ranks:
            np.testing.assert_allclose(r["out_vid"], out[:, :, t + r["lo"]:t + r["hi"]],
                                       **OUT_TOL)
        for i, name in enumerate("qkv"):
            vid = np.concatenate([r["grads_vid"][name] for r in ranks], axis=2)
            np.testing.assert_allclose(vid, grads[i][:, :, t:], err_msg=name, **GRAD_TOL)
            if t:
                text = sum(r["grads_text"][name] for r in ranks)
                np.testing.assert_allclose(text, grads[i][:, :, :t], err_msg=name,
                                           **GRAD_TOL)
        # n - 1 rotations of K and V forward; backward n - 1 of K, V, dK, dV
        # and one more of dK, dV home
        assert ranks[0]["comm"]["sendrecv"]["calls"] == 2 * (n - 1) + 1


@pytest.mark.parametrize("n", [2, 3])
def test_ring_decomposition_matches_jax(n):
    """The single-process decomposition chip_smoke.py's phase 13a runs at the
    flagship shape: what each rank of a ring of n computes (text block, then
    every video shard, merged in (out, lse)), against JAX's dense attention;
    the ranks' backward (merged lse, per-block gradients, dK / dV summed over
    the ranks) against JAX autodiff of it."""
    import jax
    import jax.numpy as jnp
    import torch

    from videopainter_tpu.ops.attention import sdpa
    from videopainter_tpu_torch.parallel.ring_attention import (ring_backward_decomposition,
                                                                 ring_forward_decomposition)

    st, sv = 5, 24
    q, k, v, dout = _qkv(2, 1, 2, st + sv, 16)

    def f(q, k, v, dout):
        out, vjp = jax.vjp(sdpa, q, k, v)
        s = jnp.einsum("bhqd,bhkd->bhqk", q, k) * q.shape[-1] ** -0.5
        return out, jax.nn.logsumexp(s, axis=-1), vjp(dout)

    out, lse, grads = jax.tree.map(np.asarray, jax.jit(f)(q, k, v, dout))
    T = torch.from_numpy
    for r in range(n):
        o, l = ring_forward_decomposition(T(q), T(k), T(v), st, n, r, use_flash=False)
        rows = np.r_[0:st, st + r * sv // n:st + (r + 1) * sv // n]
        np.testing.assert_allclose(o.numpy(), out[:, :, rows], **OUT_TOL)
        np.testing.assert_allclose(l.numpy(), lse[:, :, rows], **OUT_TOL)
    got = ring_backward_decomposition(T(q), T(k), T(v), T(dout), st, n, use_flash=False)
    for g, want, name in zip(got, grads, "qkv"):
        np.testing.assert_allclose(g.numpy(), want, err_msg=name, **GRAD_TOL)


def test_ring_needs_divisible_video_length():
    """As the JAX shard_map: the ring needs the video length divisible by the
    ring size (17,550 = 2 * 3^3 * 5^2 * 13 rings over 2 or 3, not 4); the
    all-gather path splits it as GSPMD does, ceil(S / n) with a shorter last
    shard."""
    from videopainter_tpu_torch.parallel import comm
    from videopainter_tpu_torch.parallel.sequence import seq_shard

    class Mesh:   # the three calls seq_shard makes of a DeviceMesh
        mesh_dim_names, shape = ("data", "seq", "model"), (1, 4, 1)

        def get_local_rank(self, axis):
            return 3

        def get_group(self, axis):
            return None

    with pytest.raises(ValueError, match="divisible"):
        seq_shard(None, Mesh(), 17550)
    Mesh.shape = (1, 3, 1)
    sp = seq_shard(None, Mesh(), 17550)
    assert sp.ring and sp.sizes == [5850] * 3 and sp.n == 3
    with pytest.raises(ValueError, match="needs a mesh"):
        seq_shard("seq", None, 17550)
    assert comm.shard_sizes(17550, 4) == [4388, 4388, 4388, 4386]
    assert comm.shard_range(17550, 4, 3) == (13164, 17550)
