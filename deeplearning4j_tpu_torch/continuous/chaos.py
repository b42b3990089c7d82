"""Chaos harness: deterministic streams, fault injection, parity digests.

The port of ``deeplearning4j_tpu/continuous/chaos.py``. The contract
under test: every injected fault (a poisoned NaN batch, a producer
killed mid-stream, a batch delayed past the staleness bound, SIGTERM
mid-round) ends in recovered-with-parity or a counted graceful
degradation; never a hang, never an uncounted loss. Parity is
falsifiable because everything here is deterministic:

* :func:`gen_batches` derives the stream from one seed: poisoning batch
  *i* overwrites a value without consuming extra randomness, so the good
  batches of a chaos stream and of a clean reference stream are
  bit-identical. With ``seq_len`` it makes char-RNN batches instead
  (one-hot ids whose next id is ``(5 id + 3) mod V``, from random starts);
* :func:`state_digest` hashes params, layer state, updater state, the
  iteration and what stands for the RNG chain: the port draws from
  ``step_seed(conf.seed, iteration)``, so the digest takes ``conf.seed``
  (and a carried JAX key, ``net.rng``, where a checkpoint brought one)
  where the JAX package hashes its threefry key. Two runs match iff they
  are bit-exact through the whole optimizer history. Digests never
  compare across the two packages.

The module doubles as the publisher subprocess
(``python -m deeplearning4j_tpu_torch.continuous.chaos --port ... --topic
...``), so producer death is a real process death: the harness SIGKILLs
it mid-stream (or ``--die-after`` makes it exit abruptly on its own) and
spawns a replacement that resumes at ``--start``. ``--delay-index``
publishes one batch with its timestamp aged past the staleness bound.
The publisher itself only writes codec frames to a socket; it still takes
``--device`` (default ``cuda``) and refuses to start where that device is
missing, as every entry point of the port does.
"""

from __future__ import annotations

import argparse
import hashlib
import sys
import time

import numpy as np

__all__ = ["gen_batches", "state_digest", "smoke_net", "publish_batches"]


def gen_batches(seed, n, batch=8, features=12, classes=3, poison=(), seq_len=None):
    """N deterministic ``(x, y)`` float32 minibatches from one seed.
    Indices in ``poison`` get a NaN feature, injected after drawing, so
    the other batches are unchanged by the injection. With ``seq_len``:
    char-RNN batches of ``classes`` symbols, x and y ``[batch, seq_len,
    classes]`` one-hot, y the next symbol of x (``features`` unused)."""
    poison = set(int(i) for i in poison)
    rs = np.random.RandomState(int(seed))
    out = []
    for i in range(int(n)):
        if seq_len is None:
            x = rs.rand(int(batch), int(features)).astype(np.float32)
            y = np.eye(int(classes), dtype=np.float32)[
                rs.randint(0, int(classes), int(batch))]
        else:
            x, y = _char_batch(rs, int(batch), int(seq_len), int(classes))
        if i in poison:
            x = x.copy()
            x.reshape(-1)[0] = np.nan
        out.append((x, y))
    return out


def _char_batch(rs, batch, seq_len, vocab):
    """One char-RNN minibatch: ids[t+1] = (5 ids[t] + 3) mod vocab from
    random starts, one-hot x = ids[:-1] and y = ids[1:]."""
    ids = np.zeros((batch, seq_len + 1), np.int64)
    ids[:, 0] = rs.randint(0, vocab, size=batch)
    for t in range(seq_len):
        ids[:, t + 1] = (5 * ids[:, t] + 3) % vocab
    one_hot = np.eye(vocab, dtype=np.float32)[ids]
    return (np.ascontiguousarray(one_hot[:, :seq_len]),
            np.ascontiguousarray(one_hot[:, 1:]))


def _leaf_bytes(leaf):
    import torch

    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        return t.numpy().tobytes()
    return np.asarray(leaf).tobytes()


def state_digest(net):
    """SHA-256 over params, state, opt_state, the RNG chain's seed (and a
    carried JAX key) and the iteration: equal digests, bit-exact training
    history."""
    from deeplearning4j_tpu_torch.utils.trees import tree_leaves

    h = hashlib.sha256()
    for leaf in tree_leaves([net.params, net.state, net.opt_state]):
        h.update(_leaf_bytes(leaf))
    rng = getattr(net, "rng", None)
    if rng is not None:
        h.update(np.asarray(rng).tobytes())
    h.update(f"seed={net.conf.seed}".encode())
    h.update(str(int(net.iteration)).encode())
    return h.hexdigest()


def smoke_net(seed=0, features=12, hidden=16, classes=3, device="cuda"):
    """The tiny deterministic MLP every chaos leg trains: one definition,
    so the chaos run, the resume run and the reference run can never
    drift architecturally (the JAX package's, layer for layer)."""
    from deeplearning4j_tpu_torch.nn import layers as L
    from deeplearning4j_tpu_torch.nn import updaters as U
    from deeplearning4j_tpu_torch.nn.conf import inputs as I
    from deeplearning4j_tpu_torch.nn.conf.network import NeuralNetConfig
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    conf = NeuralNetConfig(
        seed=seed, updater=U.Adam(learning_rate=0.01)).list(
        L.DenseLayer(n_out=hidden, activation="tanh"),
        L.OutputLayer(n_out=classes, loss="mcxent"),
        input_type=I.FeedForwardType(features))
    return MultiLayerNetwork(conf, device=device)


def publish_batches(port, topic, batches, *, start=0, interval_s=0.02,
                    delay_index=None, delay_s=0.0, die_after=None,
                    stall_after=None, host="127.0.0.1"):
    """Publish ``batches[start:]`` to a broker topic, one every
    ``interval_s``. ``delay_index`` publishes that batch with its
    timestamp aged by ``delay_s`` (the delayed-ingest fault: it arrives
    already stale). ``die_after`` aborts the process abruptly after that
    many publishes (producer-death fault), ``stall_after`` prints
    ``{"stalled": n}`` after that many and hangs until the process is
    killed (a wedged producer, for a harness to SIGKILL at a known point):
    both only meaningful in the subprocess entry. Returns the number
    published."""
    from deeplearning4j_tpu_torch.streaming.pubsub import NDArrayPublisher
    pub = NDArrayPublisher(topic, host=host, port=int(port))
    sent = 0
    try:
        for i in range(int(start), len(batches)):
            if die_after is not None and sent >= int(die_after):
                import os
                os._exit(1)  # abrupt: no close frames, a REAL crash
            if stall_after is not None and sent >= int(stall_after):
                print(f'{{"stalled": {sent}}}', flush=True)
                while True:
                    time.sleep(3600)
            x, y = batches[i]
            ts = None
            if delay_index is not None and i == int(delay_index):
                ts = time.time() - float(delay_s)
            pub.publish_dataset(x, y, ts=ts)
            sent += 1
            if interval_s:
                time.sleep(float(interval_s))
    finally:
        try:
            pub.close()
        except OSError:
            pass
    return sent


def main(argv=None):
    p = argparse.ArgumentParser(
        description="chaos publisher: stream deterministic batches at a "
                    "broker, with optional fault injection")
    p.add_argument("--port", type=int, required=True)
    p.add_argument("--topic", default="train")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--gen-seed", type=int, default=123)
    p.add_argument("--n", type=int, required=True,
                   help="total batches in the deterministic stream")
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--features", type=int, default=12)
    p.add_argument("--classes", type=int, default=3)
    p.add_argument("--seq-len", type=int, default=None,
                   help="char-RNN batches of --classes symbols over this many steps")
    p.add_argument("--device", default="cuda",
                   help="the device the stream feeds (default cuda; a missing card "
                        "refuses to start)")
    p.add_argument("--poison", default="",
                   help="comma-separated batch indices to NaN-poison")
    p.add_argument("--start", type=int, default=0,
                   help="resume publishing at this index (replacement "
                        "producer after a kill)")
    p.add_argument("--interval-s", type=float, default=0.02)
    p.add_argument("--delay-index", type=int, default=None)
    p.add_argument("--delay-s", type=float, default=0.0)
    p.add_argument("--die-after", type=int, default=None)
    p.add_argument("--stall-after", type=int, default=None)
    args = p.parse_args(argv)
    from deeplearning4j_tpu_torch.utils.device import resolve_device
    resolve_device(args.device)
    poison = [int(i) for i in args.poison.split(",") if i.strip()]
    batches = gen_batches(args.gen_seed, args.n, batch=args.batch,
                          features=args.features, classes=args.classes,
                          poison=poison, seq_len=args.seq_len)
    sent = publish_batches(args.port, args.topic, batches,
                           start=args.start, interval_s=args.interval_s,
                           delay_index=args.delay_index,
                           delay_s=args.delay_s, die_after=args.die_after,
                           stall_after=args.stall_after, host=args.host)
    print(f'{{"published": {sent}}}', flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
