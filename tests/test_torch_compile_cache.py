"""The port's compile-artifact tier (``utils/compile_cache.py``,
``ops/_build.py``) held against the JAX package's
``deeplearning4j_tpu/utils/compile_cache.py``, class by class as
``tests/test_compile_cache.py`` runs it: the persistent kernel cache (the
build directory, library keys over source, flags and nvcc, counted
builds), fingerprints and signatures, the warm manifest (JSON entries and
shipped libraries; each package opens the other's and refuses it, the
port without unpickling), the first-step/first-request marks, the
resumable bundle, the serving grid signatures and the warm restarts of
the serving engine, the fused engine and the ``serve`` CLI. On the CPU a
warm-up launches no kernel: its entries hold no plan and no library, and a
hit is the manifest's bookkeeping; the chip smoke's ``compile_tune`` phase
runs the same on the card."""

import io
import json
import os
import pickle
import sys
import warnings
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu import tuning as jtuning
from deeplearning4j_tpu.serving import registry as jregistry
from deeplearning4j_tpu.utils import compile_cache as jcc
from deeplearning4j_tpu_torch import telemetry, tuning
from deeplearning4j_tpu_torch.continuous import StepDriver
from deeplearning4j_tpu_torch.datasets.iterator import BucketRegistry
from deeplearning4j_tpu_torch.nn import layers as L
from deeplearning4j_tpu_torch.nn import updaters as U
from deeplearning4j_tpu_torch.nn.conf import inputs as I
from deeplearning4j_tpu_torch.nn.conf.network import NeuralNetConfig
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.ops import _build
from deeplearning4j_tpu_torch.ops import lstm_seq as LS
from deeplearning4j_tpu_torch.serving import ServingEngine, manifest_grid_signatures
from deeplearning4j_tpu_torch.utils import compile_cache as cc
from deeplearning4j_tpu_torch.utils.serialization import (load_bundle, save_bundle,
                                                         save_model)
from deeplearning4j_tpu_torch.utils.trees import flatten_tree


@pytest.fixture(autouse=True)
def _isolate(monkeypatch):
    monkeypatch.delenv(cc.ENV_CACHE_DIR, raising=False)
    monkeypatch.delenv(tuning.ENV_DB, raising=False)
    telemetry.reset()
    tuning.set_db(None)
    yield
    _build.set_build_dir(None)
    tuning.set_db(None)
    telemetry.reset()
    telemetry.disable()


def _mlp(n_in=8, n_out=4, hidden=16, seed=3, dropout=0.0):
    net = MultiLayerNetwork(
        NeuralNetConfig(seed=seed, dropout=dropout,
                        updater=U.Adam(learning_rate=1e-3)).list(
            L.DenseLayer(n_out=hidden, activation="relu"),
            L.OutputLayer(n_out=n_out, loss="mcxent"),
            input_type=I.FeedForwardType(n_in)), device="cpu")
    net.init()
    return net


def _data(n=48, n_in=8, n_out=4, seed=0):
    rs = np.random.RandomState(seed)
    x = rs.rand(n, n_in).astype(np.float32)
    y = np.eye(n_out, dtype=np.float32)[rs.randint(0, n_out, n)]
    return x, y


def _digest(net):
    return {k: v.detach().clone() for k, v in
            flatten_tree([net.params, net.state, net.opt_state]).items()}


def _counter_total(name, **labels):
    c = telemetry.get_registry().get(name)
    if c is None:
        return 0.0
    return sum(c.value(**ls) for ls in c.labelsets()
               if all(ls.get(k) == v for k, v in labels.items()))


def _fake_nvcc(tmp_path, release="V12.4.131"):
    """An nvcc stand-in: ``--version`` prints ``release``, a build writes
    its ``-o`` file."""
    path = tmp_path / f"nvcc-{release}"
    path.write_text(
        f"#!{sys.executable}\n"
        "import sys\n"
        "a = sys.argv[1:]\n"
        "if a == ['--version']:\n"
        f"    print('Cuda compilation tools, release 12.4, {release}')\n"
        "else:\n"
        "    open(a[a.index('-o') + 1], 'wb').write(b'\\x7fELF built')\n")
    path.chmod(0o755)
    return str(path)


# ---------------------------------------------------------------------------
# persistent kernel cache (tier a)
# ---------------------------------------------------------------------------

class TestPersistentCache:
    def test_enable_moves_the_build_dir(self, tmp_path):
        d = str(tmp_path / "kcache")
        assert cc.enable_persistent_cache(d) == os.path.abspath(d)
        assert os.path.isdir(d)
        assert _build.build_dir() == tmp_path / "kcache"
        assert _build.library_path(LS.SOURCE).parent == tmp_path / "kcache"

    def test_env_var_default(self, tmp_path, monkeypatch):
        d = str(tmp_path / "envcache")
        monkeypatch.setenv(cc.ENV_CACHE_DIR, d)
        assert _build.build_dir() == tmp_path / "envcache"
        assert cc.enable_persistent_cache() == os.path.abspath(d)

    def test_noop_without_dir_or_env(self):
        assert cc.enable_persistent_cache() is None
        assert _build.build_dir() == _build.BUILD_DIR

    def test_key_takes_the_source_the_flags_and_nvcc(self, tmp_path, monkeypatch):
        monkeypatch.setattr(_build, "nvcc", lambda: _fake_nvcc(tmp_path, "V12.4.131"))
        k1 = _build.library_key(LS.SOURCE)
        assert k1.startswith("lstm_seq-") and k1 == _build.library_key(LS.SOURCE)
        monkeypatch.setattr(_build, "nvcc", lambda: _fake_nvcc(tmp_path, "V12.8.93"))
        k2 = _build.library_key(LS.SOURCE)
        monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ("-G",))
        k3 = _build.library_key(LS.SOURCE)
        edited = tmp_path / "lstm_seq.cu"
        edited.write_bytes(LS.SOURCE.read_bytes() + b"\n// edited\n")
        k4 = _build.library_key(edited)
        assert len({k1, k2, k3, k4}) == 4

    def test_builds_are_counted_and_a_cached_library_is_not_a_build(self, tmp_path,
                                                                    monkeypatch):
        telemetry.enable()
        monkeypatch.setattr(_build, "nvcc", lambda: _fake_nvcc(tmp_path))
        monkeypatch.setattr(_build, "builds", {})
        monkeypatch.setattr(_build, "build_seconds", {})
        cc.enable_persistent_cache(str(tmp_path / "kc"))
        so = _build.build(LS.SOURCE)
        assert so.parent == tmp_path / "kc" and so.read_bytes() == b"\x7fELF built"
        assert _build.build(LS.SOURCE) == so
        assert _build.builds == {"lstm_seq.cu": 1} and _build.build_seconds["lstm_seq.cu"] > 0
        assert _counter_total("kernel_builds_total", source="lstm_seq.cu") == 1
        assert cc.status()["kernel_builds"] == {"lstm_seq.cu": 1}

    def _donor_manifest(self, tmp_path, monkeypatch, release):
        """A manifest shipping the lstm_seq library a host with nvcc
        ``release`` built (a fake library at that host's key)."""
        monkeypatch.setattr(_build, "nvcc", lambda: _fake_nvcc(tmp_path, release))
        donor = tmp_path / "donor"
        _build.set_build_dir(donor)
        key = _build.library_key(LS.SOURCE)
        donor.mkdir()
        (donor / f"{key}.so").write_bytes(b"\x7fELF shipped")
        rec = _build.Recording()
        rec.libraries.add("lstm_seq.cu")
        man = cc.WarmManifest("m")
        assert man.put("serving", "s", rec) and man.libraries() == {key: "lstm_seq.cu"}
        return key, man.to_bytes()

    def test_a_manifest_library_installs_without_nvcc(self, tmp_path, monkeypatch):
        """A library built by nvcc 12.4 elsewhere, shipped in a manifest,
        installs on a host with no nvcc (whose own key names no nvcc) when
        its key is what the checkout's source and flags give with 12.4,
        and the build finds it: no nvcc run. One built from another source
        is refused, counted, and the entry not served."""
        telemetry.enable()
        key, blob = self._donor_manifest(tmp_path, monkeypatch, "V12.4.131")
        with zipfile.ZipFile(io.BytesIO(blob)) as z:
            (lib,) = json.loads(z.read("manifest.json"))["libraries"]
        assert lib["nvcc"].endswith("V12.4.131") and lib["key"] == key

        def no_nvcc():
            raise RuntimeError("nvcc not found")
        monkeypatch.setattr(_build, "nvcc", no_nvcc)
        assert _build.nvcc_version() == "none" and _build.library_key(LS.SOURCE) != key
        shipped = cc.WarmManifest.from_bytes(blob)
        _build.set_build_dir(tmp_path / "empty")
        assert shipped.warm("serving", "s") is not None
        local = _build.library_path(LS.SOURCE)
        assert local.parent == tmp_path / "empty" and local.read_bytes() == b"\x7fELF shipped"
        assert _build.build(LS.SOURCE) == local
        assert cc.event_counts() == {"serialize": 1.0, "hit": 1.0}
        # another source's library: refused, counted, nothing installed
        stale = cc.WarmManifest("m")
        stale._libraries["lstm_seq-" + "0" * 16] = ("lstm_seq.cu", b"\x7fELF stale",
                                                    lib["nvcc"])
        stale._entries[("serving", "s")] = json.dumps(
            {"plans": [], "libraries": ["lstm_seq-" + "0" * 16]}).encode()
        _build.set_build_dir(tmp_path / "empty2")
        assert stale.warm("serving", "s") is None
        assert cc.event_counts().get("mismatch_drop") == 1
        assert not (tmp_path / "empty2").exists()

    def test_a_host_with_another_nvcc_builds_its_own(self, tmp_path, monkeypatch):
        telemetry.enable()
        _key, blob = self._donor_manifest(tmp_path, monkeypatch, "V12.4.131")
        monkeypatch.setattr(_build, "nvcc", lambda: _fake_nvcc(tmp_path, "V12.8.93"))
        _build.set_build_dir(tmp_path / "empty")
        assert cc.WarmManifest.from_bytes(blob).warm("serving", "s") is None
        assert cc.event_counts().get("mismatch_drop") == 1
        assert not (tmp_path / "empty").exists()

    def test_a_bundle_installs_libraries_only_into_a_chosen_cache(self, tmp_path, monkeypatch):
        """A checkpoint's manifest writes no native code into the default
        build directory: without a cache directory the caller chose, an
        entry whose library is not built here is not served (a miss) and
        nothing is written; with one, the library installs there."""
        telemetry.enable()
        _key, blob = self._donor_manifest(tmp_path, monkeypatch, "V12.4.131")
        _build.set_build_dir(None)
        monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "default")
        net = _mlp()
        man = cc.WarmManifest.from_bytes(blob)
        man.model_fp = cc.model_fingerprint(net)
        p = save_bundle(net, str(tmp_path / "b.zip"), manifest=man)
        b = load_bundle(p, device="cpu")
        assert not b.manifest.install_libraries
        assert b.manifest.warm("serving", "s") is None
        assert cc.event_counts().get("miss") == 1 and not (tmp_path / "default").exists()
        cc.enable_persistent_cache(str(tmp_path / "chosen"))
        b = load_bundle(p, device="cpu")
        assert b.manifest.install_libraries and b.manifest.warm("serving", "s") is not None
        assert _build.library_path(LS.SOURCE).parent == tmp_path / "chosen"
        assert _build.library_path(LS.SOURCE).read_bytes() == b"\x7fELF shipped"

    def test_a_library_outside_csrc_is_never_installed(self, tmp_path):
        _build.set_build_dir(tmp_path)
        assert not _build.install_library("../../evil.cu", "evil-0", b"x")
        assert not _build.install_library("nope.cu", "nope-0", b"x")
        assert not list(tmp_path.iterdir())


# ---------------------------------------------------------------------------
# fingerprints + signatures
# ---------------------------------------------------------------------------

class TestFingerprints:
    def test_same_architecture_same_fingerprint(self):
        assert cc.model_fingerprint(_mlp()) == cc.model_fingerprint(_mlp())

    def test_different_architecture_differs(self):
        assert cc.model_fingerprint(_mlp()) != cc.model_fingerprint(_mlp(hidden=32))

    def test_value_free_retrained_net_matches(self):
        net = _mlp()
        fp0 = cc.model_fingerprint(net)
        x, y = _data()
        net.fit(x, y, epochs=1, batch_size=16)
        assert cc.model_fingerprint(net) == fp0

    def test_signature_of_shapes_and_dtypes(self):
        a = cc.signature_of((torch.ones(2, 3), torch.ones(4, dtype=torch.int32)))
        b = cc.signature_of((torch.ones(2, 3), np.ones(4, np.int32)))
        c = cc.signature_of((torch.ones(2, 4), torch.ones(4, dtype=torch.int32)))
        assert a == b and a != c

    def test_signature_distinguishes_tree_structure(self):
        assert cc.signature_of(({"x": torch.ones(3)},)) != cc.signature_of((torch.ones(3),))

    def test_backend_fingerprint_names_torch_and_the_device(self):
        fp = cc.backend_fingerprint()
        assert fp.startswith(f"torch-{torch.__version__}/")
        assert fp != jcc.backend_fingerprint() and not fp.startswith("jax-")
        if not torch.cuda.is_available():
            assert fp == f"torch-{torch.__version__}/cpu"


# ---------------------------------------------------------------------------
# warm manifest (tier b)
# ---------------------------------------------------------------------------

class TestWarmManifest:
    def test_put_and_warm_roundtrip(self):
        telemetry.enable()
        m = cc.WarmManifest("model", "backend-x")
        assert m.put("k", "sig", _build.Recording())
        assert m.warm("k", "sig") == {"plans": [], "libraries": []}
        ev = cc.event_counts()
        assert ev.get("serialize") == 1 and ev.get("hit") == 1

    def test_missing_entry_counts_miss(self):
        telemetry.enable()
        assert cc.WarmManifest().warm("k", "nope") is None
        assert cc.event_counts().get("miss") == 1

    def test_load_lenient_missing_file_is_silent_none(self, tmp_path):
        telemetry.enable()
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            assert cc.WarmManifest.load_lenient(str(tmp_path / "nope.zip")) is None
        assert not cc.event_counts().get("deserialize_fail")

    def test_load_lenient_corrupt_file_warns_and_counts(self, tmp_path):
        telemetry.enable()
        bad = tmp_path / "bad.zip"
        bad.write_bytes(b"\x00junk")
        with pytest.warns(UserWarning, match="unreadable"):
            assert cc.WarmManifest.load_lenient(str(bad)) is None
        assert cc.event_counts().get("deserialize_fail") == 1

    def test_corrupt_entry_counts_deserialize_fail(self):
        telemetry.enable()
        m = cc.WarmManifest()
        m._entries[("k", "sig")] = b"not json"
        assert m.warm("k", "sig") is None
        assert cc.event_counts().get("deserialize_fail") == 1

    def test_an_entry_whose_plan_does_not_validate_is_not_served(self):
        telemetry.enable()
        m = cc.WarmManifest()
        key = [128, 64, 512, "float32", 132]
        m._entries[("k", "sig")] = json.dumps({"libraries": [], "plans": [{
            "kernel": "lstm_seq", "key": key, "config": {"variant": "persistent", "rt": 3},
            "plan": {}}]}).encode()
        assert m.warm("k", "sig") is None
        assert cc.event_counts().get("deserialize_fail") == 1

    def test_save_load_zip_and_layout(self, tmp_path):
        m = cc.WarmManifest("mfp", "bfp")
        m.put("serving", "s1", _build.Recording())
        p = m.save(str(tmp_path / "wm.zip"))
        with zipfile.ZipFile(p) as z:
            meta = json.loads(z.read("manifest.json"))
        assert {"manifest_version", "model_fp", "backend_fp", "entries"} <= set(meta)
        assert meta["entries"] == [{"kind": "serving", "signature": "s1",
                                    "file": "entry_0000.json"}]
        m2 = cc.WarmManifest.load(p)
        assert (m2.model_fp, m2.backend_fp, m2.keys()) == ("mfp", "bfp", [("serving", "s1")])

    def test_bytes_roundtrip(self):
        m = cc.WarmManifest("mfp")
        m.put("k", "s", _build.Recording())
        m2 = cc.WarmManifest.from_bytes(m.to_bytes())
        assert len(m2) == 1 and m2.backend_fp == m.backend_fp

    def test_newer_version_refused(self, tmp_path):
        p = str(tmp_path / "future.zip")
        with zipfile.ZipFile(p, "w") as z:
            z.writestr("manifest.json", json.dumps(
                {"manifest_version": cc.MANIFEST_VERSION + 1, "entries": []}))
        with pytest.raises(ValueError, match="newer"):
            cc.WarmManifest.load(p)

    def test_matches_gates_model_and_backend(self):
        net = _mlp()
        m = cc.WarmManifest.for_net(net)
        assert m.matches(net)
        assert not m.matches(_mlp(hidden=32))
        assert not cc.WarmManifest(cc.model_fingerprint(net), "torch-0.0/other").matches(net)

    def test_attach_manifest_mismatch_raises(self):
        with pytest.raises(ValueError, match="does not match"):
            cc.attach_manifest(_mlp(), cc.WarmManifest.for_net(_mlp(hidden=32)))

    def test_aot_compile_manifest_first_then_write_back(self):
        telemetry.enable()
        m = cc.WarmManifest("m")
        out1, src1 = cc.aot_compile(lambda x: x + 1.0, torch.ones(5), manifest=m, kind="t")
        assert src1 == "compile" and len(m) == 1
        out2, src2 = cc.aot_compile(lambda x: x + 1.0, torch.ones(5), manifest=m, kind="t")
        assert src2 == "manifest" and torch.equal(out1, out2)
        ev = cc.event_counts()
        assert ev == {"miss": 1.0, "capture": 2.0, "serialize": 1.0, "hit": 1.0}

    def test_a_jax_manifest_is_refused_without_unpickling(self, tmp_path, monkeypatch):
        """The JAX package's manifest (an executable compiled on the CPU,
        pickled) opens in the port and is refused by fingerprint: no byte of
        it is unpickled."""
        telemetry.enable()
        jm = jcc.WarmManifest("jax-model")
        assert jm.put("fused:k=2:health=0", "s",
                      jax.jit(lambda v: v * 2.0).lower(jnp.ones(3)).compile())
        p = jm.save(str(tmp_path / "jax_wm.zip"))

        def no_unpickle(*a, **k):
            raise AssertionError("the port unpickled a manifest")
        monkeypatch.setattr(pickle, "loads", no_unpickle)
        monkeypatch.setattr(pickle, "load", no_unpickle)
        mine = cc.WarmManifest.load(p)
        assert mine.backend_fp == jm.backend_fp and len(mine) == 1
        net = _mlp()
        with pytest.warns(UserWarning, match="not this net/backend"):
            assert cc.attach_if_matches(net, mine, "restore") is None
        assert cc.event_counts().get("mismatch_drop") == 1
        assert getattr(net, "_warm_manifest", None) is None
        # its entry, asked for anyway, is not a JSON entry: never served
        assert mine.warm("fused:k=2:health=0", "s") is None

    def test_the_port_manifest_opens_in_jax_and_fails_its_match(self, tmp_path):
        from deeplearning4j_tpu.nn import layers as JL
        from deeplearning4j_tpu.nn.conf import inputs as JI
        from deeplearning4j_tpu.nn.conf.network import NeuralNetConfig as JConf
        from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet

        m = cc.WarmManifest.for_net(_mlp())
        m.put("serving", "s", _build.Recording())
        p = m.save(str(tmp_path / "port_wm.zip"))
        theirs = jcc.WarmManifest.load(p)
        assert theirs.keys() == [("serving", "s")] and theirs.backend_fp == m.backend_fp
        jnet = JNet(JConf(seed=3).list(JL.DenseLayer(n_out=16, activation="relu"),
                                       JL.OutputLayer(n_out=4, loss="mcxent"),
                                       input_type=JI.FeedForwardType(8)))
        jnet.init()
        assert not theirs.matches(jnet)


# ---------------------------------------------------------------------------
# cold-start gauges
# ---------------------------------------------------------------------------

class TestFirstMarks:
    def test_note_first_step_stamps_once(self):
        telemetry.enable()
        ms = cc.note_first_step()
        assert ms is not None and ms > 0
        assert cc.note_first_step() is None
        assert cc.first_marks()["step"] == ms

    def test_reset_marks_via_telemetry_reset(self):
        cc.note_first_step()
        cc.note_first_request()
        telemetry.reset()
        assert cc.first_marks() == {}

    def test_fit_stamps_time_to_first_step(self):
        telemetry.enable()
        x, y = _data()
        _mlp().fit(x, y, epochs=1, batch_size=16)
        assert cc.first_marks().get("step", 0) > 0
        assert telemetry.get_registry().get("time_to_first_step_ms").value() > 0

    def test_a_served_request_stamps_time_to_first_request(self):
        telemetry.enable()
        eng = ServingEngine(_mlp(), input_spec=(8,), buckets=[1, 4], device="cpu")
        eng.output(_data(n=3)[0])
        assert cc.first_marks().get("request", 0) > 0

    def test_status_payload(self):
        telemetry.enable()
        cc.note_first_step()
        st = cc.status()
        assert set(st) >= {"persistent_cache_dir", "events", "kernel_builds",
                           "time_to_first_step_ms", "time_to_first_request_ms"}
        assert st["time_to_first_step_ms"] > 0

    def test_health_carries_compile_cache_events(self):
        telemetry.enable()
        eng = ServingEngine(_mlp(), input_spec=(8,), buckets=[1], device="cpu")
        # no manifest given: the entry warms live into the engine's own
        assert eng.health()["compile_cache_events"] == {"miss": 1.0, "capture": 1.0,
                                                         "serialize": 1.0}


# ---------------------------------------------------------------------------
# the resumable bundle
# ---------------------------------------------------------------------------

class TestResumableUnit:
    def test_bundle_folds_buckets_and_manifest(self, tmp_path):
        net = _mlp()
        cc.attach_manifest(net, cc.WarmManifest.for_net(net))
        x, y = _data()
        net.fit(x, y, epochs=1, batch_size=16, steps_per_dispatch=2)
        p = save_bundle(net, str(tmp_path / "b.zip"), buckets=BucketRegistry([8, 16]))
        b = load_bundle(p, device="cpu")
        assert b.buckets.sizes() == [8, 16]
        assert len(b.manifest) == 1 and b.manifest.keys()[0][0] == "fused:k=2:health=0"
        assert b.net._warm_manifest is b.manifest
        assert b.net.iteration == net.iteration

    def test_bundle_mismatched_manifest_dropped_with_warning(self, tmp_path):
        telemetry.enable()
        net = _mlp()
        m = cc.WarmManifest.for_net(_mlp(hidden=32))
        p = save_bundle(net, str(tmp_path / "b.zip"), manifest=m)
        with zipfile.ZipFile(p) as z:
            assert "warm_manifest.zip" not in z.namelist()  # empty manifest skipped
        m.put("k", "s", _build.Recording())
        p = save_bundle(net, str(tmp_path / "b2.zip"), manifest=m)
        with pytest.warns(UserWarning, match="manifest"):
            b = load_bundle(p, device="cpu")
        assert b.manifest is None and getattr(b.net, "_warm_manifest", None) is None
        assert cc.event_counts().get("mismatch_drop") == 1

    def test_plain_model_zip_loads_as_bundle(self, tmp_path):
        net = _mlp()
        p = save_model(net, str(tmp_path / "plain.zip"))
        b = load_bundle(p, device="cpu")
        assert b.buckets is None and b.manifest is None

    def test_corrupt_embedded_manifest_dropped_not_fatal(self, tmp_path):
        net = _mlp()
        p = save_model(net, str(tmp_path / "b.zip"))
        with zipfile.ZipFile(p, "a") as z:
            z.writestr("warm_manifest.zip", b"\x00not a zip")
        with pytest.warns(UserWarning, match="corrupt"):
            b = load_bundle(p, device="cpu")
        assert b.manifest is None

    def test_the_jax_bundle_manifest_is_dropped_by_fingerprint(self, tmp_path):
        """A JAX bundle's warm manifest (XLA executables) is refused by its
        backend fingerprint, counted ``mismatch_drop``; the net restores."""
        from deeplearning4j_tpu.nn import layers as JL
        from deeplearning4j_tpu.nn.conf import inputs as JI
        from deeplearning4j_tpu.nn.conf.network import NeuralNetConfig as JConf
        from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet
        from deeplearning4j_tpu.utils import serialization as jser

        telemetry.enable()
        jnet = JNet(JConf(seed=3).list(JL.DenseLayer(n_out=16, activation="relu"),
                                       JL.OutputLayer(n_out=4, loss="mcxent"),
                                       input_type=JI.FeedForwardType(8)))
        jnet.init()
        jm = jcc.WarmManifest.for_net(jnet)
        jm.put("k", "s", jax.jit(lambda v: v + 1).lower(jnp.ones(3)).compile())
        p = jser.save_bundle(jnet, str(tmp_path / "jax.zip"), manifest=jm)
        with pytest.warns(UserWarning, match="not this net/backend"):
            b = load_bundle(p, device="cpu")
        assert b.manifest is None and cc.event_counts().get("mismatch_drop") == 1


# ---------------------------------------------------------------------------
# the registry's grid signatures
# ---------------------------------------------------------------------------

class TestGridSignatures:
    KINDS = ("serving", "serving:grid=b=1,2;s=4,8", "serving:grid=b=1,2;s=4,8",
             "serving:mesh=[('data', 2)]:ndev=2:grid=b=2;s=8", "fused:k=2:health=0")

    @pytest.mark.parametrize("n", [0, 1, 2, 4, 5])
    def test_manifest_grid_signatures_match_jax(self, n):
        jm, mine = jcc.WarmManifest("m"), cc.WarmManifest("m")
        ex = jax.jit(lambda v: v).lower(jnp.ones(2)).compile()
        for i, kind in enumerate(self.KINDS[:n]):
            jm.put(kind, f"s{i}", ex)
            mine.put(kind, f"s{i}", _build.Recording())
        assert manifest_grid_signatures(mine) == jregistry.manifest_grid_signatures(jm)


# ---------------------------------------------------------------------------
# warm restarts: serving, the fused engine, the serve CLI
# ---------------------------------------------------------------------------

class TestWarmRestart:
    def test_serving_warm_restart(self, tmp_path):
        telemetry.enable()
        x, _ = _data(n=8, n_in=8)
        cold = ServingEngine(_mlp(), name="wrm", input_spec=(8,), buckets=[1, 4],
                             device="cpu")
        direct = cold.output(x[:3])
        wm = cold.save_warm_manifest(str(tmp_path / "wm.zip"))
        assert wm is not None and len(cc.WarmManifest.load(wm)) == 2
        telemetry.reset()
        telemetry.enable()
        warm = ServingEngine(_mlp(), name="wrm2", input_spec=(8,), buckets=[1, 4],
                             warm_manifest=wm, device="cpu")
        st = warm.stats()["aot"]
        assert st == {"warmed": 2, "manifest_hits": 2, "manifest_misses": 0,
                      "manifest": "attached"}
        assert cc.event_counts() == {"hit": 2.0, "capture": 2.0}
        np.testing.assert_array_equal(warm.output(x[:3]), direct)

    def test_a_retuned_db_misses(self, tmp_path):
        telemetry.enable()
        cold = ServingEngine(_mlp(), input_spec=(8,), buckets=[1, 4], device="cpu")
        wm = cold.save_warm_manifest(str(tmp_path / "wm.zip"))
        db = tuning.TuningDB()
        db.record("lstm", (8, 4, 16), torch.float32, {"variant": "persistent", "rt": 1})
        tuning.set_db(db)
        eng = ServingEngine(_mlp(), input_spec=(8,), buckets=[1, 4], warm_manifest=wm,
                            device="cpu")
        st = eng.stats()["aot"]
        assert st["manifest_hits"] == 0 and st["manifest_misses"] == 2
        # and what it warmed under the DB is exported under the DB's key
        fp = db.fingerprint()
        assert all(sig.endswith(f"|tuning:{fp}")
                   for _, sig in eng.export_warm_manifest().keys() if "tuning" in sig)

    def test_serving_corrupt_manifest_file_degrades_to_cold(self, tmp_path):
        bad = tmp_path / "wm.zip"
        bad.write_bytes(b"\x00definitely not a zip")
        with pytest.warns(UserWarning, match="unreadable"):
            eng = ServingEngine(_mlp(), input_spec=(8,), buckets=[1], warm_manifest=str(bad),
                                device="cpu")
        st = eng.stats()["aot"]
        assert st["manifest"] == "none" and st["warmed"] == 1 and st["manifest_hits"] == 0

    def test_serving_manifest_mismatch_refused(self, tmp_path):
        telemetry.enable()
        cold = ServingEngine(_mlp(), input_spec=(8,), buckets=[1], device="cpu")
        wm = cold.save_warm_manifest(str(tmp_path / "wm.zip"))
        eng = ServingEngine(_mlp(hidden=32), input_spec=(8,), buckets=[1], warm_manifest=wm,
                            device="cpu")
        st = eng.stats()["aot"]
        assert st["manifest"] == "mismatch" and st["manifest_hits"] == 0 and st["warmed"] == 1
        assert cc.event_counts().get("mismatch_drop") == 1

    def test_update_model_attaches_a_manifest_on_the_grid(self, tmp_path):
        from deeplearning4j_tpu_torch.serving import ModelRegistry
        telemetry.enable()
        reg = ModelRegistry()
        try:
            eng = reg.register("m", _mlp(), input_spec=(8,), buckets=[1, 4], device="cpu",
                               start=False)
            wm = eng.export_warm_manifest()
            reg.update_model("m", _mlp(), manifest=wm)
            assert eng.stats()["aot"]["manifest_hits"] == 2
        finally:
            reg.stop()

    def test_fused_warm_restore_hits_and_is_bit_exact(self, tmp_path):
        telemetry.enable()
        x, y = _data(n=64)
        ref = _mlp(dropout=0.2)
        ref.fit(x, y, epochs=2, batch_size=16, steps_per_dispatch=2)
        net = _mlp(dropout=0.2)
        cc.attach_manifest(net, cc.WarmManifest.for_net(net))
        net.fit(x, y, epochs=1, batch_size=16, steps_per_dispatch=2)
        p = save_bundle(net, str(tmp_path / "bundle.zip"))
        telemetry.reset()
        telemetry.enable()
        b = load_bundle(p, device="cpu")
        b.net.fit(x, y, epochs=1, batch_size=16, steps_per_dispatch=2)
        ev = cc.event_counts()
        assert ev.get("hit", 0) == 1 and not ev.get("miss") and not ev.get("deserialize_fail")
        (engine,) = b.net._train_steps_fused.values()
        assert engine.captures == 1  # the signature's build still counts
        mine, theirs = _digest(b.net), _digest(ref)
        assert all(torch.equal(mine[k], theirs[k]) for k in theirs)
        np.testing.assert_array_equal(b.net.rng, ref.rng)

    def test_a_stepdriver_fit_warms_through_the_manifest(self):
        telemetry.enable()
        net = _mlp()
        cc.attach_manifest(net, cc.WarmManifest.for_net(net))
        x, y = _data(n=32)
        batches = [(x[i:i + 8], y[i:i + 8], None) for i in range(0, 32, 8)]
        StepDriver(net, lambda: iter(batches), k=2, batch_size=8, prefetch=False).run(2)
        assert net._warm_manifest.keys() == [("fused:k=2:health=0", net._warm_manifest.keys()
                                              [0][1])]
        assert cc.event_counts() == {"miss": 1.0, "capture": 1.0, "serialize": 1.0}

    def test_serve_cli_warm_manifest_roundtrip(self, tmp_path, capsys):
        from deeplearning4j_tpu_torch.cli import main
        mp = str(tmp_path / "model.zip")
        save_model(_mlp(n_in=6), mp)
        wm = str(tmp_path / "wm.zip")
        args = ["serve", "--model-path", mp, "--max-batch", "4", "--buckets", "1,4",
                "--smoke", "2", "--warm-manifest", wm, "--compile-cache",
                str(tmp_path / "kc"), "--device", "cpu"]
        assert main(list(args)) == 0
        assert os.path.exists(wm) and os.path.isdir(tmp_path / "kc")
        out = capsys.readouterr().out
        cold = json.loads(out[out.index("{"):])["smoke_answers_sha256"]
        telemetry.reset()
        assert main(list(args)) == 0  # the warm leg
        out = capsys.readouterr().out
        assert "2 from warm manifest, 0 warmed live" in out
        stats = json.loads(out[out.index("{"):])
        assert stats["compile_cache"]["events"]["hit"] == 2
        assert stats["compile_cache"]["time_to_first_request_ms"] > 0
        assert stats["smoke_answers_sha256"] == cold

    def test_eval_cli_takes_the_compile_cache(self, tmp_path, capsys):
        from deeplearning4j_tpu_torch.cli import main
        mp = str(tmp_path / "model.zip")
        save_model(_mlp(), mp)
        x, y = _data(n=16)
        np.save(tmp_path / "x.npy", x)
        np.save(tmp_path / "y.npy", y)
        assert main(["eval", "--model-path", mp, "--data", str(tmp_path / "x.npy"),
                     "--labels", str(tmp_path / "y.npy"), "--device", "cpu",
                     "--compile-cache", str(tmp_path / "kc")]) == 0
        assert f"persistent kernel cache: {tmp_path / 'kc'}" in capsys.readouterr().out
        assert _build.build_dir() == tmp_path / "kc"


def test_jax_tuning_db_fingerprint_keys_the_jax_manifest_only():
    """Binding the JAX package's DB changes the JAX keys, not the port's."""
    jd = jtuning.TuningDB()
    jd.record("attention", (1, 256, 2, 32), jnp.float32, {"block_q": 128})
    jtuning.set_db(jd)
    try:
        assert jcc.full_signature("s") != "s"
        assert cc.full_signature("s") == "s"
    finally:
        jtuning.set_db(None)


@pytest.mark.parametrize("module", ["utils/compile_cache.py", "utils/serialization.py",
                                    "ops/_build.py", "ops/_plans.py", "tuning/db.py",
                                    "tuning/space.py", "tuning/measure.py", "tuning/tune.py",
                                    "serving/engine.py", "serving/registry.py"])
def test_no_module_of_the_tier_can_unpickle(module):
    """The warm-manifest path never unpickles: none of its modules imports
    pickle (or the modules that wrap it)."""
    import ast
    from pathlib import Path
    src = Path(__file__).resolve().parent.parent / "deeplearning4j_tpu_torch" / module
    names = set()
    for node in ast.walk(ast.parse(src.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module.split(".")[0])
    assert not names & {"pickle", "cPickle", "dill", "cloudpickle", "shelve", "marshal"}
