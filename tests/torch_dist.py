"""The rank programs of ``test_torch_sequence.py``, run on the CPU as gloo
processes by the port's ``parallel.launch.run_ranks``.

This module imports torch, numpy and the port only (never JAX), so a
spawned rank starts in a few seconds.
"""

import numpy as np
import torch
import torch.distributed as dist


def _np(t):
    return t.detach().numpy()


def _grads(fn, inputs, g):
    """fn(*inputs) and the gradients of sum(fn(*inputs) * g) by input."""
    xs = [torch.from_numpy(a).requires_grad_(True) for a in inputs]
    out = fn(*xs)
    (out * torch.from_numpy(g)).sum().backward()
    return [_np(out)] + [_np(x.grad) for x in xs]


def sequence_program(rank, world, q, k, v, g):
    """Every sequence-parallel check on one rank: the ring over the whole
    world (causal or not, flash blocks or naive) with the replicated
    contract, Ulysses on this rank's slice, the causal ring with the loss on
    rank 0 alone, the single-rank ring of a seq=1 mesh, the collectives and
    the mesh's layout."""
    from deeplearning4j_tpu_torch.parallel import mesh as M
    from deeplearning4j_tpu_torch.parallel import sequence as S

    out = {}
    mesh = M.make_mesh(M.MeshSpec(data=1, seq=world))
    t_local = q.shape[1] // world
    sl = slice(rank * t_local, (rank + 1) * t_local)
    for causal in (False, True):
        for flash in (False, True):
            fn = S.make_ring_attention_fn(mesh, causal=causal, use_flash=flash)
            res = _grads(fn, (q, k, v), g)
            for name, a in zip(("out", "dq", "dk", "dv"), res):
                out[f"ring_{causal:d}{flash:d}_{name}"] = a
        uly = _grads(lambda a, b, c: S.ulysses_self_attention(a, b, c, group=mesh.group("seq"),
                                                              causal=causal),
                     (q[:, sl], k[:, sl], v[:, sl]), g[:, sl])
        for name, a in zip(("out", "dq", "dk", "dv"), uly):
            out[f"ulysses_{causal:d}_{name}"] = a

    # the loss on rank 0 alone: every block rank 0 sees is its own, so the
    # later ranks' k and v must get exactly zero gradient through the
    # masked off-diagonal blocks
    for flash in (False, True):
        g0 = g[:, sl] if rank == 0 else np.zeros_like(g[:, sl])
        res = _grads(lambda a, b, c: S.ring_self_attention(a, b, c, causal=True, use_flash=flash),
                     (q[:, sl], k[:, sl], v[:, sl]), g0)
        out[f"masked_{flash:d}_dk"], out[f"masked_{flash:d}_dv"] = res[2], res[3]

    # a mesh whose seq axis has one rank: the ring is one diagonal block
    solo = M.make_mesh(M.MeshSpec(seq=1))
    res = _grads(S.make_ring_attention_fn(solo, causal=True), (q, k, v), g)
    for name, a in zip(("out", "dq", "dk", "dv"), res):
        out[f"solo_{name}"] = a
    out["solo_seq_ranks"] = solo.ranks("seq")
    out["solo_data_ranks"] = solo.ranks("data")

    # the collectives: a shift by one and its transpose, a single send, an
    # all-to-all and its inverse
    x = torch.full((2, 3), float(rank), requires_grad=True)
    y = S.ppermute(x, [(j, (j + 1) % world) for j in range(world)])
    (y * (rank + 1)).sum().backward()
    out["ppermute"], out["ppermute_grad"] = _np(y), _np(x.grad)
    out["ppermute_partial"] = _np(S.ppermute(x.detach() + 1, [(0, world - 1)]))
    x = torch.arange(world * 6, dtype=torch.float32).reshape(1, world * 2, 3) + 100 * rank
    x.requires_grad_(True)
    y = S.all_to_all(x, 1, 2)
    back = S.all_to_all(y, 2, 1)
    (y * torch.arange(y.numel(), dtype=torch.float32).reshape(y.shape)).sum().backward()
    out["a2a"], out["a2a_back"], out["a2a_grad"] = _np(y), _np(back), _np(x.grad)

    # the mesh: row-major layout, one group a line, refusal of a bad spec
    if world % 2 == 0:
        m2 = M.make_mesh(M.MeshSpec(data=-1, seq=2))
        out["mesh_coords"] = [m2.coords[a] for a in M.AXES]
        out["mesh_seq_ranks"] = m2.ranks("seq")
        out["mesh_data_ranks"] = m2.ranks("data")
        out["mesh_seq_group_size"] = dist.get_world_size(m2.group("seq"))
    try:
        M.make_mesh(M.MeshSpec(data=1, seq=world + 1))
        out["refusal"] = ""
    except ValueError as e:
        out["refusal"] = str(e)
    return out


def rank_one_fails(rank, world):
    """Rank 1 raises; every other rank returns its rank and the world. All
    ranks meet at a barrier first, so rank 1 cannot leave while another is
    still connecting to it (gloo's full mesh)."""
    dist.barrier()
    if rank == 1:
        raise ValueError("rank 1 fails on purpose")
    return {"rank": rank, "world": dist.get_world_size()}
