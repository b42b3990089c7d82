"""The port's sequence parallelism and flash block entry against the JAX
package.

``ops.attention.flash_attention_block`` (out, lse and the VJP with nonzero
cotangents on both) against the JAX ``flash_attention_block`` in interpret
mode; ``parallel.mesh`` (``MeshSpec.resolve``, ``make_mesh``'s layout and
refusal); and ``parallel.sequence``'s ring attention (causal or not, flash
blocks or naive, forward and gradients), Ulysses attention, the
single-rank ring, the masked causal blocks' zero gradient and the two
differentiable collectives, run as P in {2, 4} gloo processes
(the rank programs of ``tests/torch_dist.py``, spawned once for each P by
``parallel.launch.run_ranks``) and held against the JAX
package's ``make_ring_attention_fn`` / ``ulysses_self_attention`` on the
8-device virtual mesh (``MeshSpec(data=8 // P, seq=P)``), on the same numpy
inputs.

Tolerances: the JAX ring tests' (tests/test_attention.py): forward rtol
2e-4 + atol 2e-5, gradients rtol 1e-3 + atol 1e-4; the block entry's out
and lse rtol 1e-5 + atol 1e-6 and its VJP rtol 1e-4 + atol 1e-5
(tests/test_attention.py's block test).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist
from deeplearning4j_tpu.nn.layers.attention import dot_product_attention as j_dpa
from deeplearning4j_tpu.ops import attention_pallas as jfa
from deeplearning4j_tpu.parallel import MeshSpec as JMeshSpec
from deeplearning4j_tpu.parallel import make_mesh as j_make_mesh
from deeplearning4j_tpu.parallel import sequence as JS
from deeplearning4j_tpu.utils.compat import shard_map
from deeplearning4j_tpu_torch.ops import attention as tfa
from deeplearning4j_tpu_torch.parallel import launch as TL
from deeplearning4j_tpu_torch.parallel import mesh as TM
from deeplearning4j_tpu_torch.parallel import sequence as TS

B, T, H, D = 2, 32, 4, 8
FWD = dict(rtol=2e-4, atol=2e-5)
GRAD = dict(rtol=1e-3, atol=1e-4)


def _inputs():
    rs = np.random.RandomState(11)
    return {name: rs.randn(B, T, H, D).astype(np.float32) for name in ("q", "k", "v", "g")}


@pytest.fixture(scope="module", params=[2, 4], ids=["P2", "P4"])
def ranks(request, tmp_path_factory):
    """(P, the inputs, each rank's results): one spawn of P gloo processes."""
    p = request.param
    inputs = _inputs()
    results = TL.run_ranks(torch_dist.sequence_program, p, tmp_path_factory.mktemp(f"ranks{p}"),
                           **inputs)
    return p, inputs, results


def _jax_vjp(fn, inputs):
    """fn(q, k, v) and its VJP at g, compiled as one program."""
    def run(q, k, v, g):
        out, vjp = jax.vjp(fn, q, k, v)
        return (out, *vjp(g))
    res = jax.jit(run)(*(jnp.asarray(inputs[n]) for n in ("q", "k", "v", "g")))
    return [np.asarray(a) for a in res]


@functools.lru_cache(maxsize=None)
def _jax_ring(p, causal):
    mesh = j_make_mesh(JMeshSpec(data=8 // p, seq=p), devices=jax.devices()[:8])
    return _jax_vjp(JS.make_ring_attention_fn(mesh, causal=causal), _inputs())


@functools.lru_cache(maxsize=None)
def _jax_ulysses(p, causal):
    mesh = j_make_mesh(JMeshSpec(data=8 // p, seq=p), devices=jax.devices()[:8])
    spec = jax.sharding.PartitionSpec(None, "seq", None, None)
    fn = shard_map(functools.partial(JS.ulysses_self_attention, axis_name="seq", causal=causal),
                   mesh=mesh, in_specs=(spec, spec, spec), out_specs=spec, check_vma=False)
    return _jax_vjp(fn, _inputs())


NAMES = ("out", "dq", "dk", "dv")


# ---------------------------------------------------------------------------
# across ranks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("flash", [False, True], ids=["naive", "flash"])
@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_ring_attention_matches_jax_ring(ranks, causal, flash):
    """Every rank returns the whole output and, with the same loss on every
    rank, the whole dq, dk, dv (the replicated contract)."""
    p, _, results = ranks
    want = _jax_ring(p, causal)
    for r, res in enumerate(results):
        for name, w in zip(NAMES, want):
            tol = FWD if name == "out" else GRAD
            np.testing.assert_allclose(res[f"ring_{causal:d}{flash:d}_{name}"], w, **tol,
                                       err_msg=f"rank {r} {name}")


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_ulysses_attention_matches_jax_ulysses(ranks, causal):
    p, _, results = ranks
    want = _jax_ulysses(p, causal)
    for name, w in zip(NAMES, want):
        got = np.concatenate([res[f"ulysses_{causal:d}_{name}"] for res in results], axis=1)
        np.testing.assert_allclose(got, w, **(FWD if name == "out" else GRAD), err_msg=name)


@pytest.mark.parametrize("flash", [False, True], ids=["naive", "flash"])
def test_masked_causal_blocks_give_exactly_zero_gradient(ranks, flash):
    """With the loss on rank 0 alone, the later ranks' k and v reach it only
    through off-diagonal blocks the causal mask hides whole: their gradient
    is exactly zero (not small), and finite; rank 0's is not zero."""
    _, _, results = ranks
    for r, res in enumerate(results):
        for name in ("dk", "dv"):
            a = res[f"masked_{flash:d}_{name}"]
            assert np.isfinite(a).all()
            if r:
                assert (a == 0).all(), f"rank {r} {name}: max |grad| {np.abs(a).max()}"
            else:
                assert np.abs(a).max() > 0


def test_single_rank_ring_is_plain_attention(ranks):
    """A mesh whose seq axis has one rank (seq=1, data=P): the ring is the
    diagonal block alone and equals whole-T attention."""
    p, inputs, results = ranks
    q, k, v, g = (jnp.asarray(inputs[n]) for n in ("q", "k", "v", "g"))
    out, vjp = jax.vjp(lambda a, b, c: j_dpa(a, b, c, causal=True), q, k, v)
    want = [np.asarray(out)] + [np.asarray(x) for x in vjp(g)]
    for r, res in enumerate(results):
        assert list(res["solo_seq_ranks"]) == [r]
        assert list(res["solo_data_ranks"]) == list(range(p))
        for name, w in zip(NAMES, want):
            np.testing.assert_allclose(res[f"solo_{name}"], w,
                                       **(FWD if name == "out" else GRAD), err_msg=name)


def test_ppermute_and_all_to_all_with_their_transposes(ranks):
    p, _, results = ranks
    for r, res in enumerate(results):
        # a shift by one: rank r gets r - 1's value; the backward sends the
        # cotangent (r + 1 on rank r) back along the inverse shift
        np.testing.assert_array_equal(res["ppermute"], np.full((2, 3), (r - 1) % p))
        np.testing.assert_array_equal(res["ppermute_grad"], np.full((2, 3), (r + 1) % p + 1))
        # rank 0 sends its 1s to the last rank alone: the others receive zeros
        np.testing.assert_array_equal(res["ppermute_partial"],
                                      np.full((2, 3), float(r == p - 1)))
        # tiled all-to-all, split axis 1, concat axis 2: rank r gets chunk r
        # of every rank's x, side by side in rank order
        xs = [np.arange(p * 6, dtype=np.float32).reshape(1, p * 2, 3) + 100 * s
              for s in range(p)]
        want = np.concatenate([x[:, 2 * r:2 * r + 2] for x in xs], axis=2)
        np.testing.assert_array_equal(res["a2a"], want)
        np.testing.assert_array_equal(res["a2a_back"], xs[r])
    # the backward is the inverse all-to-all of each rank's cotangent (the
    # same arange on every rank): chunk s of rank r's x gets rank s's
    # cotangent columns of r
    cot = np.arange(2 * p * 3, dtype=np.float32).reshape(1, 2, 3 * p)
    for r, res in enumerate(results):
        np.testing.assert_array_equal(res["a2a_grad"], np.concatenate(
            [cot[:, :, 3 * r:3 * r + 3] for _ in range(p)], axis=1))


def test_make_mesh_layout_and_refusal(ranks):
    """Ranks sit row-major in (data, model, seq, stage), as the JAX mesh
    reshapes its devices; a spec that does not cover the world raises."""
    p, _, results = ranks
    layout = np.arange(p).reshape(p // 2, 1, 2, 1)
    for r, res in enumerate(results):
        d, m, s, st = (int(c) for c in res["mesh_coords"])
        assert layout[d, m, s, st] == r
        assert list(res["mesh_seq_ranks"]) == list(layout[d, m, :, st])
        assert list(res["mesh_data_ranks"]) == list(layout[:, m, s, st])
        assert int(res["mesh_seq_group_size"]) == 2
        assert str(res["refusal"]) == f"mesh 1x1x{p + 1}x1 != {p} devices"


def test_run_ranks_reports_a_failed_rank(tmp_path):
    """A rank that raises fails the run with its traceback; unless the run
    is not required, where that rank's result is None."""
    with pytest.raises(RuntimeError, match="rank 1 fails on purpose"):
        TL.run_ranks(torch_dist.rank_one_fails, 2, tmp_path / "required")
    got = TL.run_ranks(torch_dist.rank_one_fails, 2, tmp_path / "optional", required=False)
    assert got == [{"rank": 0, "world": 2}, None]


# ---------------------------------------------------------------------------
# in one process
# ---------------------------------------------------------------------------

def test_mesh_spec_resolves_as_the_jax_spec():
    for spec, n in [((-1, 1, 1, 1), 8), ((-1, 2, 2, 1), 8), ((2, 1, 4, 1), 8), ((-1, 1, 4, 1), 4),
                    ((1, 1, 1, 1), 1)]:
        assert TM.MeshSpec(*spec).resolve(n) == JMeshSpec(*spec).resolve(n)
    for spec, n in [((-1, 1, 3, 1), 8), ((2, 1, 2, 1), 8), ((-1, 1, 5, 1), 4)]:
        with pytest.raises(ValueError, match="devices"):
            TM.MeshSpec(*spec).resolve(n)
        with pytest.raises(AssertionError):
            JMeshSpec(*spec).resolve(n)


def test_make_mesh_needs_an_initialised_process_group():
    with pytest.raises(RuntimeError, match="init_process_group"):
        TM.make_mesh(TM.MeshSpec())


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("t", [16, 40])
def test_flash_block_matches_jax_flash_block(t, causal):
    """(out, lse) and the VJP with random nonzero cotangents on both."""
    rs = np.random.RandomState(t + causal)
    q, k, v = (rs.randn(1, t, 2, 8).astype(np.float32) for _ in range(3))
    scale = 1.0 / 8.0 ** 0.5
    g_out = rs.randn(1, t, 2, 8).astype(np.float32)
    g_lse = rs.randn(1, 2, t).astype(np.float32)
    (jo, jl), vjp = jax.vjp(lambda a, b, c: jfa.flash_attention_block(a, b, c, causal, scale,
                                                                      True),
                            *(jnp.asarray(x) for x in (q, k, v)))
    jgrads = vjp((jnp.asarray(g_out), jnp.asarray(g_lse)))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    to, tl = tfa.flash_attention_block(tq, tk, tv, causal, scale)
    np.testing.assert_allclose(to.detach().numpy(), np.asarray(jo), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tl.detach().numpy(), np.asarray(jl), rtol=1e-5, atol=1e-6)
    tgrads = torch.autograd.grad((to, tl), (tq, tk, tv),
                                 (torch.from_numpy(g_out), torch.from_numpy(g_lse)))
    for name, a, b in zip(("dq", "dk", "dv"), tgrads, jgrads):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4, atol=1e-5, err_msg=name)


def test_flash_block_lse_cotangent_is_the_softmax_row():
    """d(sum(lse * g_lse))/dq through the block entry equals autograd
    through the plain version's lse; with g_lse = 0 the gradients are
    ``flash_attention``'s to the bit."""
    rs = np.random.RandomState(3)
    q, k, v = (torch.from_numpy(rs.randn(2, 24, 2, 8).astype(np.float32)).requires_grad_(True)
               for _ in range(3))
    g_out = torch.from_numpy(rs.randn(2, 24, 2, 8).astype(np.float32))
    g_lse = torch.from_numpy(rs.randn(2, 2, 24).astype(np.float32))
    out, lse = tfa.flash_attention_block(q, k, v, True, None)
    got = torch.autograd.grad((out, lse), (q, k, v), (g_out, g_lse))
    po, pl = tfa.flash_attention_plain(q, k, v, causal=True)
    want = torch.autograd.grad((po, pl), (q, k, v), (g_out, g_lse))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4, atol=1e-5)
    out, lse = tfa.flash_attention_block(q, k, v, True, None)
    no_lse = torch.autograd.grad((out, lse), (q, k, v), (g_out, torch.zeros_like(g_lse)))
    plain = torch.autograd.grad(tfa.flash_attention(q, k, v, causal=True), (q, k, v), g_out)
    for a, b in zip(no_lse, plain):
        assert torch.equal(a, b)


def test_combine_weighs_absent_blocks_zero_without_nan_gradients():
    """-inf (an absent block, or the naive block's fully masked row) and the
    kernel's -1e30 sentinel combine alike, and two -inf give no NaN."""
    acc = torch.randn(1, 3, 1, 2, requires_grad=True)
    out_b = torch.randn(1, 3, 1, 2, requires_grad=True)
    lse_run = torch.tensor([[[0.5, -np.inf, tfa.NEG_INF]]], requires_grad=True)
    lse_b = torch.tensor([[[-np.inf, -np.inf, 1.0]]], requires_grad=True)
    new, lse_new = TS._combine(acc, lse_run, out_b, lse_b)
    (new.sum() + torch.where(torch.isfinite(lse_new), lse_new, 0.0).sum()).backward()
    np.testing.assert_allclose(new[0, 0].detach().numpy(), acc[0, 0].detach().numpy(), rtol=1e-6)
    assert (new[0, 1] == 0).all()
    np.testing.assert_allclose(new[0, 2].detach().numpy(), out_b[0, 2].detach().numpy(),
                               rtol=1e-6)
    for t in (acc, out_b, lse_run, lse_b):
        assert torch.isfinite(t.grad).all()
    assert (out_b.grad[0, :2] == 0).all()


def test_naive_and_flash_blocks_agree_on_masked_rows():
    """A diagonal causal block through ``_naive_block`` and through the
    block entry: the same out and lse (the first row sees one key)."""
    rs = np.random.RandomState(4)
    q, k, v = (torch.from_numpy(rs.randn(1, 8, 2, 4).astype(np.float32)) for _ in range(3))
    pos = torch.arange(8)
    mask = (pos[:, None] >= pos[None, :])[None, None]
    out_n, lse_n = TS._naive_block(q, k, v, 0.5, mask)
    out_f, lse_f = tfa.flash_attention_block(q, k, v, True, 0.5)
    np.testing.assert_allclose(out_n.numpy(), out_f.numpy(), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(lse_n.numpy(), lse_f.numpy(), rtol=1e-5, atol=1e-6)


def test_flash_blocks_are_chosen_only_where_the_kernel_runs():
    assert not TS._use_flash_blocks(torch.zeros(1, 4, 2, 8))
    assert tfa.supported((4, 4096, 8, 64), torch.float32)
    assert tfa.supported((4, 4096, 8, 128), torch.bfloat16)
    assert not tfa.supported((4, 4096, 8, 256), torch.float32)
    assert not tfa.supported((4, 4096, 8, 64), torch.float64)
