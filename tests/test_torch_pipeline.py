"""The port's LM pipelines (``PipelineParallelLM`` and the composed
dp x tp x pp ``ComposedParallelLM``; GPipe and 1F1B) against the JAX
package.

One spawn of 4 gloo ranks (``tests/torch_dist_model.py pipeline_program``)
on the meshes stage=4, data=2 x stage=2, model=2 x stage=2 and data=2 x
model=2, from the JAX models' initial weights. The JAX package's own tests
pin each pipeline to the sequential computation on the same parameters;
the reference here is that computation in the JAX package: its
``loss_reference`` math (the embedding, the block stack and the head on
one device) and its ``jax.grad``. After one SGD step (lr 0.1) the port's
whole parameters are held against ``p - 0.1 g``. Losses at rtol 1e-5
(``tests/test_pipeline.py``), the composed LM's at rtol 2e-4
(``tests/test_composed.py``); parameters at rtol 2e-4 + atol 1e-6
(``tests/test_pipeline.py``'s gradient tolerance).

Then: the 1F1B stash bound, ZeRO-1 of the composed LM's updater state
(losses unchanged at rtol 1e-5, the JAX test's), and the LM's sharded
checkpoint round trip (the next step's loss within 1e-5).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax import lax

import torch_dist_model as TDM
from deeplearning4j_tpu.parallel import MeshSpec as JMeshSpec
from deeplearning4j_tpu.parallel import make_mesh as j_make_mesh
from deeplearning4j_tpu.parallel.composed import ComposedParallelLM as JComposed
from deeplearning4j_tpu.parallel.composed import _causal_attention as j_attention
from deeplearning4j_tpu.parallel.composed import _ln as j_ln
from deeplearning4j_tpu.parallel.pipeline import PipelineParallelLM as JPipeLM
from deeplearning4j_tpu_torch.parallel import launch as TL

LOSS = dict(rtol=1e-5)
COMPOSED_LOSS = dict(rtol=2e-4)
GRAD = dict(rtol=2e-4, atol=1e-6)


def _np(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a), tree)


def _nll(params, h, labels):
    logits = h @ params["head"]["W"] + params["head"]["b"]
    logp = jax.nn.log_softmax(logits.astype(jnp.float32), axis=-1)
    return -jnp.mean(jnp.take_along_axis(logp, labels[..., None], axis=-1))


def _lm_ref(model, params, ids, labels):
    """JAX's ``PipelineParallelLM.loss_reference`` as a function of the
    parameters: (loss, the parameters after one SGD step)."""
    def loss(p):
        emb, _ = model.embed.apply(p["embed"], {}, ids)
        h, _ = lax.scan(lambda h, bp: (model.block.apply(bp, {}, h)[0], None), emb,
                        p["blocks"])
        return _nll(p, h, labels)
    val, g = jax.jit(jax.value_and_grad(loss))(params)
    return float(val), _np(jax.tree_util.tree_map(lambda a, b: a - TDM.LR * b, params, g))


def _composed_ref(model, params, ids, labels):
    """JAX's ``ComposedParallelLM.loss_reference`` as a function of the
    parameters, the same way."""
    from deeplearning4j_tpu.nn import activations as _act

    def body(h, bp):
        x = h
        hn = j_ln(x, bp["ln1_g"], bp["ln1_b"])
        qkv = jnp.einsum("btd,dghe->btghe", hn, bp["Wqkv"]) + bp["bqkv"]
        attn = j_attention(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2])
        x = x + jnp.einsum("bthe,hed->btd", attn, bp["Wo"]) + bp["bo"]
        hn = j_ln(x, bp["ln2_g"], bp["ln2_b"])
        m = _act.get("gelu")(jnp.einsum("btd,df->btf", hn, bp["W1"]) + bp["b1"])
        return (x + jnp.einsum("btf,fd->btd", m, bp["W2"]) + bp["b2"]).astype(h.dtype), None

    def loss(p):
        emb, _ = model.embed.apply(p["embed"], {}, ids)
        h, _ = lax.scan(body, emb, p["blocks"])
        return _nll(p, h, labels)
    val, g = jax.jit(jax.value_and_grad(loss))(params)
    return float(val), _np(jax.tree_util.tree_map(lambda a, b: a - TDM.LR * b, params, g))


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    rs = np.random.RandomState(0)
    ids = rs.randint(0, TDM.LM["vocab_size"], (TDM.LM_BATCH, TDM.LM["seq_len"]))
    labels = np.roll(ids, -1, axis=1)
    jmesh = j_make_mesh(JMeshSpec(data=1, model=1, seq=1, stage=4), devices=jax.devices()[:4])
    jlm = JPipeLM(**TDM.LM, mesh=jmesh).init()
    lm = _np(jlm.params)
    cmesh = j_make_mesh(JMeshSpec(data=1, model=2, seq=1, stage=2), devices=jax.devices()[:4])
    jcomp = JComposed(**TDM.LM, mesh=cmesh).init()
    composed = _np(jcomp.params)

    ref = {"lm": _lm_ref(jlm, jlm.params, jnp.asarray(ids), jnp.asarray(labels)),
           "composed": _composed_ref(jcomp, jcomp.params, jnp.asarray(ids),
                                     jnp.asarray(labels))}
    root = tmp_path_factory.mktemp("pipe")
    ranks = TL.run_ranks(TDM.pipeline_program, 4, root, timeout=300, lm=lm, composed=composed,
                         ids=ids, labels=labels, ckpt=str(root / "ckpt"))
    return ref, ranks


def _assert_lm(got, ref, loss_tol):
    loss, after = ref
    np.testing.assert_allclose(got["ref"], loss, **loss_tol)
    np.testing.assert_allclose(got["loss"], loss, **loss_tol)
    for k in ("embed", "head"):
        for name, a in got[k].items():
            np.testing.assert_allclose(a, after[k][name], err_msg=f"{k}.{name}", **GRAD)
    blocks = after["blocks"]
    for i, bp in enumerate(got["blocks"]):
        for path, a in jax.tree_util.tree_flatten_with_path(bp)[0]:
            want = blocks
            for key in path:
                want = want[key.key]
            np.testing.assert_allclose(a, want[i], err_msg=f"block {i} {path}", **GRAD)


@pytest.mark.parametrize("case", [("stage4", "gpipe"), ("stage4", "1f1b"),
                                  ("data2_stage2", "1f1b")])
def test_pipeline_lm_matches_jax_sequential(run, case):
    """``loss_reference``, the pipelined step's loss and the parameters
    after one SGD step on every rank, against the JAX sequential loss and
    gradient."""
    for r in run[1]:
        _assert_lm(r["lm"][case], run[0]["lm"], LOSS)


@pytest.mark.parametrize("case", [("model2_stage2", "gpipe"), ("model2_stage2", "1f1b"),
                                  ("data2_model2", "gpipe")])
def test_composed_lm_matches_jax_sequential(run, case):
    """dp x tp x pp: the head-split blocks (gathered whole) after one SGD
    step, and the losses, against the JAX composed LM's sequential math."""
    for r in run[1]:
        _assert_lm(r["composed"][case], run[0]["composed"], COMPOSED_LOSS)


def test_1f1b_stashes_at_most_n_stages(run):
    """GPipe holds every microbatch's activations on every stage; 1F1B holds
    at most S - s on stage s (4 microbatches, 4 stages)."""
    for s, r in enumerate(run[1]):
        assert r["lm"][("stage4", "gpipe")]["stash"] == 4
        assert r["lm"][("stage4", "1f1b")]["stash"] == min(4 - s, 4)


def test_composed_zero1_state_sharded_and_losses_identical(run):
    """ZeRO-1 over data=2 halves the updater state's split leaves and
    changes no loss or parameter (rtol 1e-5, the JAX test's)."""
    for r in run[1]:
        z = r["composed_zero"]
        np.testing.assert_allclose(z[True]["losses"], z[False]["losses"], rtol=1e-5)
        assert z[True]["m_shape"][0] * 2 == z[False]["m_shape"][0]
        for a, b in zip(jax.tree_util.tree_leaves(z[True]["blocks"]),
                        jax.tree_util.tree_leaves(z[False]["blocks"])):
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-7)


def test_lm_sharded_checkpoint_round_trip(run):
    """Save after a step on data=2 x stage=2, restore into a fresh LM: the
    iteration comes back and the next step's loss is the uninterrupted
    run's (within 1e-5)."""
    for r in run[1]:
        assert r["ckpt"]["iteration"] == 1
        assert abs(r["ckpt"]["a"] - r["ckpt"]["b"]) < 1e-5
