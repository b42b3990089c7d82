"""The port's streaming tier (``deeplearning4j_tpu_torch/streaming/``)
held against the JAX package's (``tests/test_streaming.py``): codec frames
byte for byte in both directions, a JAX publisher through the port's
broker into a port subscriber (and the reverse), topic isolation, counted
drops at a full broker outbox, and a port net trained from a stream."""

import queue
import socket
import threading
import time

import numpy as np
import pytest

from deeplearning4j_tpu import streaming as jstream
from deeplearning4j_tpu_torch import telemetry
from deeplearning4j_tpu_torch import streaming as tstream
from deeplearning4j_tpu_torch.streaming import codec as tcodec


@pytest.fixture(autouse=True)
def _isolate():
    telemetry.reset()
    telemetry.disable()
    yield
    telemetry.disable()
    telemetry.reset()


def _arrays():
    rs = np.random.RandomState(0)
    return [(rs.rand(3, 4, 5) * 100).astype(dt)
            for dt in (np.float32, np.float64, np.int32, np.uint8)]


def test_ndarray_frames_are_byte_identical_both_ways():
    import torch

    for a in _arrays():
        mine, theirs = tstream.encode_ndarray(a), jstream.encode_ndarray(a)
        assert mine == theirs
        got = jstream.decode_ndarray(mine)  # the port encodes, JAX decodes
        assert got.dtype == a.dtype
        np.testing.assert_array_equal(got, a)
        back = tstream.decode_ndarray(theirs)  # and the reverse
        assert back.dtype == a.dtype
        np.testing.assert_array_equal(back, a)
    # a tensor goes on the wire as its array would
    t = torch.arange(12, dtype=torch.float32).reshape(3, 4)
    assert tstream.encode_ndarray(t) == jstream.encode_ndarray(t.numpy())
    assert tstream.encode_ndarray(t.bfloat16()) == jstream.encode_ndarray(t.numpy())


def test_dataset_frames_are_byte_identical_with_and_without_ts():
    rs = np.random.RandomState(1)
    f = rs.rand(8, 28, 28, 1).astype(np.float32)
    l = np.eye(10, dtype=np.float32)[np.arange(8)]
    for ts in (None, 1.7e9 + 0.25):
        mine, theirs = tstream.encode_dataset(f, l, ts=ts), jstream.encode_dataset(f, l, ts=ts)
        assert mine == theirs
        for buf, decode in ((mine, jstream.decode_dataset), (theirs, tstream.decode_dataset)):
            f2, l2 = decode(buf)
            np.testing.assert_array_equal(f2, f)
            np.testing.assert_array_equal(l2, l)
        assert tcodec.dataset_ts(mine) == ts
    with pytest.raises(ValueError, match="magic"):
        tstream.decode_ndarray(b"JUNKxxxx")
    with pytest.raises(ValueError, match="not a dataset"):
        tstream.decode_dataset(jstream.encode_ndarray(f))


def test_jax_publisher_through_the_port_broker_into_a_port_subscriber():
    broker = tstream.StreamingBroker().start()
    try:
        sub = tstream.NDArraySubscriber("t1", port=broker.port)
        time.sleep(0.05)  # let SUB register
        pub = jstream.NDArrayPublisher("t1", port=broker.port)
        a = np.arange(12, dtype=np.float32).reshape(3, 4)
        pub.publish(a)
        np.testing.assert_array_equal(sub.receive(timeout=5), a)
        x, y = a * 2, np.eye(4, dtype=np.float32)[[0, 1, 2]]
        pub.publish_dataset(x, y, ts=time.time() - 3.0)
        age, (x2, y2), ts = sub.receive_timed(timeout=5)
        np.testing.assert_array_equal(x2, x)
        np.testing.assert_array_equal(y2, y)
        assert ts is not None and age >= 3.0  # aged from the JAX publisher's stamp
        pub.close()
        sub.close()
    finally:
        broker.close()


def test_port_publisher_through_the_jax_broker_and_topic_isolation():
    broker = jstream.StreamingBroker().start()
    try:
        sub_a = jstream.NDArraySubscriber("a", port=broker.port)
        sub_b = tstream.NDArraySubscriber("b", port=broker.port)
        time.sleep(0.05)
        pub = tstream.NDArrayPublisher("a", port=broker.port)
        pub.publish(np.ones(3, np.float32))
        np.testing.assert_array_equal(sub_a.receive(timeout=5), np.ones(3, np.float32))
        with pytest.raises(queue.Empty):
            sub_b.queue.get(timeout=0.2)
        pub.close()
        sub_a.close()
        sub_b.close()
    finally:
        broker.close()


def test_drops_at_a_full_outbox_are_counted():
    """A subscriber that never reads must not stall the topic: the port
    broker's bounded outbox drops oldest, counted, while the healthy
    subscriber's books balance (received + dropped = published)."""
    telemetry.enable()
    broker = tstream.StreamingBroker(subscriber_buffer=2).start()
    try:
        def await_subs(n):
            deadline = time.time() + 10
            while time.time() < deadline:
                with broker._lock:
                    if len(broker._subs["t"]) == n:
                        return
                time.sleep(0.02)
            raise AssertionError(f"subscription {n} never registered")

        healthy = tstream.NDArraySubscriber("t", port=broker.port)
        await_subs(1)
        wedged = socket.socket()
        wedged.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, 4096)
        wedged.connect(("127.0.0.1", broker.port))
        wedged.sendall(b"SUB t\n")
        await_subs(2)
        pub = jstream.NDArrayPublisher("t", port=broker.port)
        payload = np.random.RandomState(0).rand(512, 1024).astype(np.float32)
        for _ in range(12):
            pub.publish(payload)
        got = 0
        while got < 12:
            try:
                _age, arr, _ts = healthy.receive_timed(timeout=3.0)
            except queue.Empty:
                break
            assert arr.shape == (512, 1024)
            got += 1
        assert got >= 1, "healthy subscriber starved behind the wedge"
        with broker._lock:
            healthy_box = broker._subs["t"][0]
        assert got + healthy_box.dropped + healthy.dropped == 12
        deadline = time.time() + 10
        while broker.dropped_total() == 0 and time.time() < deadline:
            time.sleep(0.05)
        assert broker.dropped_total() >= 1
        reg = telemetry.get_registry()
        assert reg.get("stream_dropped_total").value(site="broker") == broker.dropped_total()
        pub.close()
        healthy.close()
        wedged.close()
    finally:
        broker.close()


def test_streaming_training_matches_the_batches_fit():
    """A port net fit from a ``StreamingDataSetIterator`` takes the same
    steps as the same net fit from the published batches directly."""
    from deeplearning4j_tpu_torch.continuous import chaos
    from deeplearning4j_tpu_torch.utils.trees import tree_leaves

    batches = chaos.gen_batches(4, 5)
    broker = tstream.StreamingBroker().start()
    try:
        sub = tstream.NDArraySubscriber("train", port=broker.port)
        time.sleep(0.05)

        def produce():
            pub = jstream.NDArrayPublisher("train", port=broker.port)
            for x, y in batches:
                pub.publish_dataset(x, y)
            pub.close()

        threading.Thread(target=produce, daemon=True).start()
        net = chaos.smoke_net(seed=3, device="cpu")
        net.fit(tstream.StreamingDataSetIterator(sub, num_batches=5, timeout=10), epochs=1)
        sub.close()
    finally:
        broker.close()
    ref = chaos.smoke_net(seed=3, device="cpu")
    ref.fit(iter(batches), epochs=1)
    assert net.iteration == ref.iteration == 5
    for a, b in zip(tree_leaves(net.params), tree_leaves(ref.params)):
        assert np.array_equal(a.detach().numpy(), b.detach().numpy())
