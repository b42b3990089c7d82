"""The port's kernel tuner (``deeplearning4j_tpu_torch/tuning``) held
against the JAX package's ``deeplearning4j_tpu/tuning``, class by class as
``tests/test_tuning.py`` runs it, less the TPU-only cases (the (8, 128)
tile rule, the VMEM budget): the config spaces of the Hopper kernels'
``plan()``s with their static pruning, the TuningDB (the same keys and
document; each package's DB loads in the other and misses there), the
parity gate, the dispatch seams (a tuned config applies where it
validates, one DB lookup a distinct plan, a rebind empties the caches),
the warm-restart composition and the ``tune`` CLI. On the CPU the drivers
time the kernels' plain versions: the search, the gate and the DB run, the
kernels do not."""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu import tuning as jtuning
from deeplearning4j_tpu.tuning import db as jdb
from deeplearning4j_tpu.tuning import measure as jmeasure
from deeplearning4j_tpu_torch import telemetry, tuning
from deeplearning4j_tpu_torch.nn.layers import attention as TA
from deeplearning4j_tpu_torch.ops import _build
from deeplearning4j_tpu_torch.ops import attention as A
from deeplearning4j_tpu_torch.ops import conv_stats as C
from deeplearning4j_tpu_torch.ops import lstm_seq as L
from deeplearning4j_tpu_torch.tuning import db as tdb
from deeplearning4j_tpu_torch.tuning import tune as ttune
from deeplearning4j_tpu_torch.utils import compile_cache as cc

F32 = torch.float32
BF16 = torch.bfloat16


@pytest.fixture(autouse=True)
def _isolate(monkeypatch):
    monkeypatch.delenv(tuning.ENV_DB, raising=False)
    monkeypatch.delenv(jtuning.ENV_DB, raising=False)
    monkeypatch.delenv("DL4J_TPU_FUSED_ATTENTION_MIN_SEQ", raising=False)
    telemetry.reset()
    tuning.set_db(None)
    jtuning.set_db(None)
    yield
    tuning.set_db(None)
    jtuning.set_db(None)
    telemetry.reset()
    telemetry.disable()


def _events():
    return tuning.event_counts()


def _resnet_conv_keys():
    """{(kernel id, DB key shape)} of the fused ResNet50's conv calls at
    batch 64, 224x224 (its config only: no weights)."""
    from deeplearning4j_tpu_torch.models import resnet50
    conf = resnet50(224, 224, n_classes=1000, fused=True)
    types = conf.vertex_types()
    keys = set()
    for v in conf.vertices:
        if type(v.vertex).__name__ != "FusedConvBNVertex":
            continue
        it = types[v.inputs[0]]
        (sh, sw), cout = tuple(v.vertex.stride), v.vertex.n_out
        ho, wo = -(-it.height // sh), -(-it.width // sw)
        keys.add(("conv_matmul", (64 * ho * wo, it.channels, cout))
                 if tuple(v.vertex.kernel) == (1, 1)
                 else ("conv3x3", (64, ho, wo, it.channels, cout)))
    return sorted(keys)


# ---------------------------------------------------------------------------
# config spaces: static pruning
# ---------------------------------------------------------------------------

class TestSpace:
    def test_enumerate_lists_every_combination(self):
        assert len(tuning.enumerate_space("conv_matmul")) == 16
        assert len(tuning.enumerate_space("conv3x3")) == 16
        lstm = tuning.enumerate_space("lstm")
        assert {c["variant"] for c in lstm} == {"persistent", "step_cluster"} and len(lstm) == 7
        att = tuning.enumerate_space("attention")
        assert {"backend": "plain"} in att and len(att) == 6

    def test_not_compiled_rejects(self):
        r = tuning.validate("conv_matmul", {"bm": 64, "bn": 64, "blocks_per_sm": 1},
                            (4096, 256, 256), F32)
        assert r and r.startswith("not compiled")
        r = tuning.validate("lstm", {"variant": "persistent", "rt": 3}, (128, 8, 512), F32)
        assert r and r.startswith("not compiled")
        r = tuning.validate("lstm", {"variant": "step_cluster", "split": 16}, (128, 8, 512), F32)
        assert r and r.startswith("not compiled")
        r = tuning.validate("attention", {"backend": "flash", "variant": "f32_3xtf32_wgmma"},
                            (1, 256, 2, 128), F32)
        assert r and r.startswith("not compiled")

    def test_grid_the_variant_does_not_take(self):
        r = tuning.validate("conv_matmul", {"bm": 128, "bn": 128, "blocks_per_sm": 0},
                            (4096, 256, 256), F32)
        assert r and r.startswith("grid")

    def test_shared_memory_rejects(self):
        # a persistent block at H=1024, rt 4: 303,616 B of Wh slice and rows
        r = tuning.validate("lstm", {"variant": "persistent", "rt": 4}, (128, 64, 1024), F32)
        assert r and r.startswith("smem")
        # two 128x128 bf16_wgmma blocks do not fit one SM's shared memory
        r = tuning.validate("conv_matmul", {"bm": 128, "bn": 128, "blocks_per_sm": 2},
                            (4096, 256, 256), BF16)
        assert r and r.startswith("co-residency")

    def test_persistent_grid_must_be_co_resident(self):
        cfg = {"variant": "persistent", "rt": 1}
        # 64 unit groups x 8 batch groups: 512 blocks, one an SM by plan()'s arithmetic
        r = tuning.validate("lstm", cfg, (128, 64, 512), F32)
        assert r and r.startswith("co-residency")
        # the card's occupancy query decides where it is asked
        assert tuning.validate("lstm", cfg, (128, 64, 512), F32, occupancy=lambda rt: 4) is None
        assert tuning.validate("lstm", cfg, (128, 64, 512), F32, occupancy=lambda rt: 2)

    def test_alignment_and_stride_rules(self):
        r = tuning.validate("lstm", {"variant": "persistent", "rt": 1}, (16, 4, 102), F32)
        assert r and r.startswith("alignment")
        wg = {"backend": "flash", "variant": "f32_3xtf32_wgmma"}
        assert tuning.validate("attention", wg, (1, 256, 2, 64), F32) is None
        r = tuning.validate("attention", wg, (1, 256, 2, 64), F32, aligned=False)
        assert r and r.startswith("alignment")
        odd = ((256 * 2 * 65, 2 * 65, 65),) * 3
        r = tuning.validate("attention", wg, (1, 256, 2, 64), F32, strides=odd)
        assert r and r.startswith("alignment")
        assert tuning.validate("attention", {"backend": "flash", "variant": "f32_3xtf32_unaligned"},
                               (1, 256, 2, 64), F32, strides=odd) is None
        r = tuning.validate("attention", {"backend": "flash", "variant": "bf16_wgmma"},
                            (1, 256, 2, 64), F32)
        assert r and r.startswith("dtype")
        assert tuning.validate("attention", {"backend": "plain"}, (1, 256, 2, 64), F32) is None

    def test_split_that_leaves_a_rank_nothing(self):
        r = tuning.validate("lstm", {"variant": "step_cluster", "split": 8}, (16, 4, 4), F32)
        assert r and r.startswith("redundant")

    def test_prune_splits_and_keeps_the_default_of_a_clamped_group(self):
        # 2 rows x 512 channels: every grid clamps to the 4 tiles of a 64x128 tile
        shape = (2, 512, 512)
        default = tuning.default_config("conv_matmul", shape, F32)
        cands = [{"bm": 64, "bn": 128, "blocks_per_sm": 1}, default,
                 {"bm": 64, "bn": 64, "blocks_per_sm": 1}]
        valid, rejected = tuning.prune("conv_matmul", cands, shape, F32, keep=default)
        assert valid == [default]
        reasons = sorted(r.split(":")[0] for _, r in rejected)
        assert reasons == ["not compiled", "redundant"]

    @pytest.mark.parametrize("dtype", [F32, BF16])
    def test_every_default_plan_validates_at_the_main_paths(self, dtype):
        """Nothing that can fault reaches a launch: each default plan of
        the ResNet50's convs, the char-RNN's and H=1024's LSTM and the
        LM's attention is a valid, unpruned candidate."""
        shapes = [*_resnet_conv_keys(),
                  ("lstm", (128, 64, 512)), ("lstm", (128, 1, 512)), ("lstm", (128, 8, 512)),
                  ("lstm", (128, 64, 1024)), ("lstm", (128, 8, 1024)), ("lstm", (128, 4, 102)),
                  ("attention", (4, 4096, 8, 64)), ("attention", (2, 1000, 8, 128))]
        for kernel, shape in shapes:
            default = tuning.default_config(kernel, shape, dtype)
            assert tuning.validate(kernel, default, shape, dtype) is None, (kernel, shape)
            valid, _ = tuning.prune(kernel, tuning.enumerate_space(kernel), shape, dtype,
                                    keep=default)
            assert default in valid, (kernel, shape)


# ---------------------------------------------------------------------------
# TuningDB: round-trip, degradation, counters, the other package's DB
# ---------------------------------------------------------------------------

class TestDB:
    @pytest.mark.parametrize("shape", [(1, 1000, 3, 64), (128, 64, 512), (200704, 64, 256),
                                       (64, 7, 7, 512, 512), (0, 1, 2, 3), (5,)])
    def test_bucket_shape_matches_jax(self, shape):
        assert tuning.bucket_shape(shape) == jtuning.bucket_shape(shape)

    @pytest.mark.parametrize("kernel,shape", [("attention", (4, 4096, 8, 64)),
                                              ("conv_matmul", (50176, 128, 512)),
                                              ("conv3x3", (64, 28, 28, 128, 128)),
                                              ("lstm", (128, 64, 512))])
    @pytest.mark.parametrize("pair", [(F32, jnp.float32), (BF16, jnp.bfloat16)])
    def test_keys_less_the_backend_match_jax(self, kernel, shape, pair):
        mine = tdb._key(kernel, shape, pair[0], "BACKEND")
        assert mine == jdb._key(kernel, shape, pair[1], "BACKEND")
        assert mine == tdb._key(kernel, shape, str(pair[0]).removeprefix("torch."), "BACKEND")

    def test_record_lookup_counters(self):
        telemetry.enable()
        db = tuning.TuningDB()
        db.record("lstm", (128, 64, 512), F32, {"variant": "persistent", "rt": 4})
        assert _events().get("tune") == 1
        # same bucket (T=100 -> 128) hits; another bucket misses
        assert db.lookup("lstm", (100, 64, 512), F32) == {"variant": "persistent", "rt": 4}
        assert _events().get("hit") == 1
        assert db.lookup("lstm", (128, 64, 1024), F32) is None
        assert _events().get("miss") == 1

    def test_save_load_roundtrip_and_document(self, tmp_path):
        db = tuning.TuningDB()
        db.record("conv_matmul", (256, 128, 128), F32, {"bm": 128, "bn": 128,
                                                          "blocks_per_sm": 1}, score_ms=1.5)
        p = str(tmp_path / "db.json")
        db.save(p)
        doc = json.loads(open(p).read())
        assert set(doc) == {"tuning_db_version", "backend_note", "entries"}
        (entry,) = doc["entries"].values()
        assert set(entry) == {"config", "kernel", "shape_bucket", "dtype", "score_ms"}
        db2 = tuning.TuningDB.load(p)
        assert db2.entries == db.entries
        assert db2.lookup("conv_matmul", (256, 128, 128), F32)["bm"] == 128

    def test_corrupt_file_degrades_counted(self, tmp_path):
        telemetry.enable()
        p = tmp_path / "bad.json"
        p.write_text("{ not json !!")
        with pytest.warns(UserWarning, match="unusable"):
            assert tuning.TuningDB.load_lenient(str(p)) is None
        assert _events().get("mismatch_drop") == 1

    def test_version_mismatch_degrades_counted(self, tmp_path):
        telemetry.enable()
        p = tmp_path / "future.json"
        p.write_text(json.dumps({"tuning_db_version": 99, "entries": {}}))
        with pytest.warns(UserWarning, match="newer"):
            assert tuning.TuningDB.load_lenient(str(p)) is None
        assert _events().get("mismatch_drop") == 1

    def test_missing_file_silent(self, tmp_path):
        telemetry.enable()
        assert tuning.TuningDB.load_lenient(str(tmp_path / "absent.json")) is None
        assert not _events().get("mismatch_drop")

    def test_a_jax_db_loads_in_the_port_and_misses(self, tmp_path):
        telemetry.enable()
        jd = jtuning.TuningDB()
        jd.record("attention", (1, 256, 2, 32), jnp.float32, {"block_q": 128, "block_k": 128})
        p = str(tmp_path / "jax.json")
        jd.save(p)
        mine = tuning.TuningDB.load(p)
        assert len(mine) == 1
        assert mine.lookup("attention", (1, 256, 2, 32), F32) is None
        assert _events().get("miss") == 1 and not _events().get("mismatch_drop")

    def test_a_port_db_loads_in_jax_and_misses(self, tmp_path):
        db = tuning.TuningDB()
        db.record("attention", (1, 256, 2, 32), F32, {"backend": "flash",
                                                        "variant": "f32_3xtf32_wgmma"})
        p = str(tmp_path / "port.json")
        db.save(p)
        theirs = jtuning.TuningDB.load(p)
        assert len(theirs) == 1
        assert theirs.lookup("attention", (1, 256, 2, 32), jnp.float32) is None

    def test_backend_mismatch_misses(self):
        telemetry.enable()
        db = tuning.TuningDB()
        db.entries["lstm|128,64,512|float32|torch-0.0/cuda-0.0/H100/sm_90"] = {
            "config": {"variant": "persistent", "rt": 4}}
        assert db.lookup("lstm", (128, 64, 512), F32) is None
        assert _events().get("miss") == 1

    def test_env_resolution_and_explicit_override(self, tmp_path, monkeypatch):
        db = tuning.TuningDB()
        db.record("lstm", (128, 64, 512), F32, {"variant": "step_cluster", "split": 2})
        p = str(tmp_path / "env.json")
        db.save(p)
        monkeypatch.setenv(tuning.ENV_DB, p)
        cfg = tuning.tuned_config("lstm", (128, 64, 512), F32)
        assert cfg == {"variant": "step_cluster", "split": 2}
        other = tuning.TuningDB()
        tuning.set_db(other)  # an explicit binding wins over the env artifact
        assert tuning.tuned_config("lstm", (128, 64, 512), F32) is None
        tuning.set_db(None)   # back to env resolution
        assert tuning.tuned_config("lstm", (128, 64, 512), F32) == cfg
        assert L.launch_plan(128, 64, 512, F32).variant == "step_cluster"

    def test_fingerprint_tracks_content(self):
        db = tuning.TuningDB()
        db.record("lstm", (128, 64, 512), F32, {"variant": "persistent", "rt": 4})
        f1 = db.fingerprint()
        db.record("lstm", (128, 64, 512), F32, {"variant": "persistent", "rt": 2})
        assert db.fingerprint() != f1


# ---------------------------------------------------------------------------
# measurement harness: parity gate + timing
# ---------------------------------------------------------------------------

class TestMeasure:
    def test_parity_diff_matches_jax(self):
        rs = np.random.RandomState(0)
        a = rs.rand(2, 2).astype(np.float32)
        b = rs.rand(3).astype(np.float32)
        c = (a * 1.5, b)
        nan = np.full((2, 2), np.nan, np.float32)
        cases = [((a, b), (a, b)), ((a, b), c), ((a, b), a), ((nan, b), (a, b)),
                 ({"x": a, "y": b}, {"x": a * 2, "y": b}), ((a,), (a.T.copy(),))]
        for out, ref in cases:
            mine = tuning.parity_diff(
                tuple(torch.from_numpy(np.asarray(x)) for x in out) if isinstance(out, tuple)
                else {k: torch.from_numpy(v) for k, v in out.items()} if isinstance(out, dict)
                else torch.from_numpy(out), ref)
            theirs = jmeasure.parity_diff(out, ref)
            assert mine == pytest.approx(theirs, rel=0, abs=0) or mine == theirs == float("inf")

    def test_time_callable_runs(self):
        x = torch.arange(8.0)
        dt = tuning.time_callable(lambda x: x * 2.0, (x,), iters=3, reps=1)
        assert dt > 0 and np.isfinite(dt)

    def test_time_windows_and_the_spread(self):
        from deeplearning4j_tpu_torch.tuning import measure
        x = torch.arange(8.0)
        w = measure.time_windows(lambda x: x * 2.0, (x,), iters=2, reps=3)
        assert len(w) == 3 and all(v > 0 for v in w)
        _, (m,) = tuning.search("demo", [{"a": 1}], lambda c: (lambda x: x * 2.0), (x,),
                                lambda x: x * 2.0, iters=2, reps=3)
        assert m.spread is not None and m.spread >= 0

    @pytest.mark.parametrize("fast_s, spreads, kept", [
        (0.90, (0.01, 0.01), "fastest"),   # 10% faster, beyond both spreads
        (0.97, (0.05, 0.0), "default"),    # inside the fastest's spread
        (0.97, (0.0, 0.05), "default"),    # inside the default's spread
        (0.995, (0.0, 0.0), "default"),    # inside MIN_GAIN with no spread
        (0.98, (0.0, 0.0), "fastest"),     # beyond MIN_GAIN, no spread
    ])
    def test_the_default_stays_unless_beaten_beyond_the_noise(self, fast_s, spreads, kept):
        from deeplearning4j_tpu_torch.tuning.measure import Measurement
        fast = Measurement({"c": 1}, seconds_per_iter=fast_s, spread=spreads[0])
        base = Measurement({"c": 0}, seconds_per_iter=1.0, spread=spreads[1])
        chosen, margin = ttune._chosen(fast, base)
        assert chosen is (fast if kept == "fastest" else base)
        assert margin == pytest.approx(max(*spreads, ttune.MIN_GAIN))
        assert ttune._chosen(base, base) == (base, None)

    def test_parity_rejection_rejects_wrong_candidate(self):
        telemetry.enable()
        x = torch.arange(16.0)

        def build(cfg):
            scale = 1.001 if cfg["bug"] else 1.0
            return lambda x: x * (2.0 * scale)

        winner, results = tuning.search("demo", [{"bug": True}, {"bug": False}], build, (x,),
                                        lambda x: x * 2.0, iters=2, reps=1)
        assert winner is not None and winner.config == {"bug": False}
        rejected = [m for m in results if not m.ok]
        assert len(rejected) == 1 and rejected[0].config == {"bug": True}
        assert "parity" in rejected[0].rejected and not rejected[0].raised
        assert _events().get("reject") == 1

    def test_raising_candidate_is_rejected(self):
        telemetry.enable()

        def build(cfg):
            if cfg["raise"]:
                return lambda x: (_ for _ in ()).throw(RuntimeError("launch refused"))
            return lambda x: x + 1.0

        winner, results = tuning.search("demo", [{"raise": True}, {"raise": False}], build,
                                        (torch.zeros(3),), lambda x: x + 1.0, iters=1, reps=1)
        assert winner.config == {"raise": False}
        assert results[0].raised and "launch refused" in results[0].rejected
        assert _events().get("reject") == 1

    def test_search_all_rejected_returns_none(self):
        telemetry.enable()
        winner, results = tuning.search("demo", [{"bug": True}], lambda c: (lambda x: x + 1.0),
                                        (torch.arange(4.0),), lambda x: x * 2.0, iters=1, reps=1)
        assert winner is None and not results[0].ok
        assert _events().get("reject") == 1

    def test_rejected_candidate_never_persisted(self):
        telemetry.enable()
        db = tuning.TuningDB()
        x = torch.arange(16.0)

        def build(cfg):
            scale = 1.001 if cfg["bug"] else 1.0
            return lambda x: x * (2.0 * scale)

        winner, _ = tuning.search("demo", [{"bug": True}, {"bug": False}], build, (x,),
                                  lambda x: x * 2.0, iters=2, reps=1)
        db.record("demo", (16,), F32, winner.config)
        assert _events().get("tune") == 1 == len(db)

    def test_gates(self):
        ref = torch.ones(4, 4)
        gate = ttune.close_gate(1e-4)
        assert gate(ref + 5e-5, ref) is None and gate(ref + 2e-4, ref)
        assert ttune.close_gate(2e-2, 2e-2)(ref * 1.03, ref) is None
        z = torch.randn(8, 4, generator=torch.Generator().manual_seed(0))
        stats = torch.stack((z.sum(0), (z * z).sum(0)))
        g = ttune.conv_gate(F32)
        assert g((z, stats), (z, stats)) is None
        assert "stats" in g((z, stats + 1.0), (z, stats))
        assert g((z + 1.0, stats), (z, stats)).startswith("z ")


# ---------------------------------------------------------------------------
# the dispatch seams consult the DB
# ---------------------------------------------------------------------------

class TestSeams:
    def test_without_a_db_every_launch_plan_is_plan(self):
        for x_shape, cout, stride, dt in (((64, 56, 56, 64), 256, (1, 1), F32),
                                          ((64, 56, 56, 128), 128, (2, 2), BF16),
                                          ((64, 7, 7, 512), 2048, (1, 1), F32)):
            for ks in (1, 3):
                assert C.launch_plan(ks, x_shape, cout, stride, dt) == \
                    C.plan(ks, x_shape, cout, stride, dt)
        for b, h, dt in ((64, 512, F32), (1, 512, BF16), (64, 1024, F32), (4, 100, F32)):
            assert L.launch_plan(128, b, h, dt) == L.plan(b, h, dt)
        for shape, dt in (((4, 4096, 8, 64), F32), ((4, 4096, 8, 64), BF16),
                          ((2, 1000, 8, 128), F32)):
            assert A.launch_plan(shape, dt) == A.plan(shape, dt)
        assert len(C.PLANS) and not tuning.event_counts()

    def test_a_tuned_config_applies(self):
        db = tuning.TuningDB()
        db.record("conv_matmul", (64 * 56 * 56, 64, 256), F32,
                  {"bm": 64, "bn": 128, "blocks_per_sm": 4})
        db.record("conv3x3", (64, 28, 28, 128, 128), F32, {"bm": 64, "bn": 128,
                                                           "blocks_per_sm": 2})
        db.record("lstm", (128, 64, 512), F32, {"variant": "step_cluster", "split": 2})
        db.record("attention", (4, 4096, 8, 64), F32, {"backend": "flash",
                                                       "variant": "f32_3xtf32"})
        tuning.set_db(db)
        pl = C.launch_plan(1, (64, 56, 56, 64), 256, (1, 1), F32)
        assert (pl.bm, pl.bn, pl.blocks_per_sm, pl.grid) == (64, 128, 4, 4 * C.H100_SMS)
        # a stride-2 3x3 keys as the stride-1 call of its output size
        pl = C.launch_plan(3, (64, 56, 56, 128), 128, (2, 2), F32)
        assert (pl.bm, pl.bn, pl.blocks_per_sm) == (64, 128, 2)
        pl = L.launch_plan(128, 64, 512, F32)
        assert (pl.variant, pl.split) == ("step_cluster", 2)
        pl = A.launch_plan((4, 4096, 8, 64), F32)
        assert (pl.variant, pl.dp) == ("f32_3xtf32", 128)
        # the buckets round up: T=100 takes the T=128 winner
        assert L.launch_plan(100, 64, 512, F32).variant == "step_cluster"

    def test_an_invalid_config_falls_back_to_the_default(self):
        db = tuning.TuningDB()
        db.record("conv_matmul", (64 * 56 * 56, 64, 256), F32,
                  {"bm": 64, "bn": 64, "blocks_per_sm": 1})
        db.record("lstm", (128, 64, 512), F32, {"variant": "persistent", "rt": 1})
        db.record("attention", (4, 4096, 8, 64), F32, {"backend": "flash",
                                                       "variant": "bf16_wgmma"})
        tuning.set_db(db)
        assert C.launch_plan(1, (64, 56, 56, 64), 256, (1, 1), F32) == \
            C.plan(1, (64, 56, 56, 64), 256, (1, 1), F32)
        assert L.launch_plan(128, 64, 512, F32) == L.plan(64, 512, F32)
        assert A.launch_plan((4, 4096, 8, 64), F32) == A.plan((4, 4096, 8, 64), F32)
        # the tuned variant's stride rule holds at the actual call only
        db.record("attention", (1, 256, 2, 64), F32, {"backend": "flash",
                                                      "variant": "f32_3xtf32_wgmma"})
        odd = ((256 * 2 * 65, 2 * 65, 65),) * 3
        assert A.launch_plan((1, 256, 2, 64), F32, odd).variant == "f32_3xtf32_unaligned"

    def test_resolve_attention_db_over_env_over_min_seq(self, monkeypatch):
        long_, short = (1, 4096, 2, 32), (1, 256, 2, 32)
        assert TA.resolve_attention(long_, long_, None, F32)
        assert not TA.resolve_attention(short, short, None, F32)
        monkeypatch.setenv("DL4J_TPU_FUSED_ATTENTION_MIN_SEQ", "128")
        assert TA.resolve_attention(short, short, None, F32)
        monkeypatch.setenv("DL4J_TPU_FUSED_ATTENTION_MIN_SEQ", "8192")
        assert not TA.resolve_attention(long_, long_, None, F32)
        db = tuning.TuningDB()
        db.record("attention", long_, F32, {"backend": "flash", "variant": "f32_3xtf32_wgmma"})
        db.record("attention", short, F32, {"backend": "plain"})
        tuning.set_db(db)
        monkeypatch.setenv("DL4J_TPU_FUSED_ATTENTION_MIN_SEQ", "0")
        # the DB verdict wins over the environment, in both directions
        assert TA.resolve_attention(long_, long_, None, F32)
        assert not TA.resolve_attention(short, short, None, F32)
        # an explicit min_seq is the caller's decision
        assert TA.resolve_attention(short, short, None, F32, min_seq=0)

    def test_the_crossover_verdict_matches_the_jax_seam(self):
        """The same DB verdicts (the JAX package's ``xla`` is the port's
        ``plain``) give the same dispatch decisions in both packages."""
        long_, short = (1, 2048, 2, 32), (1, 256, 2, 32)
        jd, mine = jtuning.TuningDB(), tuning.TuningDB()
        jd.record("attention", long_, jnp.float32, {"backend": "xla"})
        jd.record("attention", short, jnp.float32, {"backend": "flash", "block_q": 128,
                                                    "block_k": 128})
        mine.record("attention", long_, F32, {"backend": "plain"})
        mine.record("attention", short, F32, {"backend": "flash",
                                              "variant": "f32_3xtf32_wgmma"})
        from deeplearning4j_tpu.ops import attention_pallas as jap
        for bound in (False, True):
            jtuning.set_db(jd if bound else None)
            tuning.set_db(mine if bound else None)
            for shape in (long_, short):
                theirs = jap.resolve_attention(shape, shape, None, jnp.float32, min_seq=None)
                assert TA.resolve_attention(shape, shape, None, F32) == (theirs is not None)

    def test_n_resolutions_count_one_hit(self):
        db = tuning.TuningDB()
        db.record("lstm", (128, 64, 512), F32, {"variant": "persistent", "rt": 4})
        db.record("attention", (4, 4096, 8, 64), F32, {"backend": "flash",
                                                       "variant": "f32_3xtf32_wgmma"})
        tuning.set_db(db)
        telemetry.enable()
        for _ in range(10):
            L.launch_plan(128, 64, 512, F32)
            TA.resolve_attention((4, 4096, 8, 64), (4, 4096, 8, 64), None, F32)
            A.launch_plan((4, 4096, 8, 64), F32)
        assert _events() == {"hit": 2.0}
        L.launch_plan(128, 8, 512, F32)  # another plan: one more lookup
        assert _events() == {"hit": 2.0, "miss": 1.0}

    def test_a_rebind_empties_the_caches(self):
        db = tuning.TuningDB()
        db.record("lstm", (128, 64, 512), F32, {"variant": "step_cluster", "split": 4})
        tuning.set_db(db)
        assert L.launch_plan(128, 64, 512, F32).split == 4
        assert len(L.PLANS) == 1
        tuning.set_db(None)
        assert len(L.PLANS) == 0
        assert L.launch_plan(128, 64, 512, F32) == L.plan(64, 512, F32)
        # a record into the bound DB is a new binding too
        tuning.set_db(db)
        db.record("lstm", (128, 64, 512), F32, {"variant": "step_cluster", "split": 8})
        assert L.launch_plan(128, 64, 512, F32).split == 8

    def test_an_explicit_config_is_validated_on_the_cpu_too(self):
        """The tuner's candidates are pinned as the plan of a call key for
        a block (``PlanCache.pinned``): the launch plan there is the
        candidate's, then the default again; a config that does not
        validate at the key is refused with its reason, on the CPU too,
        where the wrappers' results do not change."""
        rs = np.random.RandomState(0)
        x = torch.from_numpy(rs.rand(2, 4, 4, 8).astype(np.float32))
        w = torch.from_numpy(rs.rand(8, 16).astype(np.float32))
        key = C.plan_key(1, (2, 4, 4, 8), 16, (1, 1), F32)
        default = C.launch_plan(1, (2, 4, 4, 8), 16, (1, 1), F32)
        good = {"bm": 64, "bn": 128, "blocks_per_sm": 2}
        with C.PLANS.pinned(key, good) as pl:
            assert C.launch_plan(1, (2, 4, 4, 8), 16, (1, 1), F32) == pl
            assert (pl.bm, pl.bn, pl.blocks_per_sm) == (64, 128, 2) and pl != default
            z, stats = C.conv_mm_stats(x, w)
        zp, sp = C.conv_mm_stats_plain(x, w)
        assert torch.equal(z, zp) and torch.equal(stats, sp)
        assert C.launch_plan(1, (2, 4, 4, 8), 16, (1, 1), F32) == default
        with pytest.raises(ValueError, match="not compiled"):
            with C.PLANS.pinned(key, {"bm": 64, "bn": 64, "blocks_per_sm": 1}):
                pass
        with pytest.raises(ValueError, match="not compiled"):
            with L.PLANS.pinned(L.plan_key(4, 2, 16, F32), {"variant": "persistent", "rt": 3}):
                pass
        with pytest.raises(ValueError, match="dtype"):
            with A.PLANS.pinned(A.plan_key((1, 8, 2, 16), F32),
                                {"backend": "flash", "variant": "bf16_wgmma"}):
                pass

    def test_seams_take_the_cpu_plain_versions_unchanged_under_a_db(self):
        """A DB bound changes no CPU result: the wrappers take the plain
        versions on CPU tensors whatever the plan."""
        db = tuning.TuningDB()
        db.record("lstm", (8, 2, 16), F32, {"variant": "step_cluster", "split": 2})
        rs = np.random.RandomState(1)
        xz = torch.from_numpy(rs.rand(8, 2, 64).astype(np.float32))
        wh = torch.from_numpy(rs.rand(16, 64).astype(np.float32) * 0.1)
        h0 = torch.zeros(2, 16)
        before = L.lstm_seq(xz, wh, h0, h0).hs
        tuning.set_db(db)
        assert torch.equal(L.lstm_seq(xz, wh, h0, h0).hs, before)


# ---------------------------------------------------------------------------
# warm-restart composition: DB + manifest
# ---------------------------------------------------------------------------

class TestWarmRestart:
    def test_full_signature_passthrough_without_db(self):
        assert cc.full_signature("sig") == "sig"
        db = tuning.TuningDB()
        tuning.set_db(db)  # bound but EMPTY: still a passthrough
        assert cc.full_signature("sig") == "sig"
        db.record("lstm", (128, 64, 512), F32, {"variant": "persistent", "rt": 4})
        assert cc.full_signature("sig") == f"sig|tuning:{db.fingerprint()}"

    def test_warm_restart_seeds_tuned_plans_with_no_lookup(self):
        """A warm-up records the tuned plan into the manifest; after a
        restart (fresh caches) the entry seeds it: the launch resolves no
        DB lookup, the manifest counts a hit and the warm-up a capture."""
        telemetry.enable()
        db = tuning.TuningDB()
        db.record("lstm", (128, 64, 512), F32, {"variant": "step_cluster", "split": 4})
        tuning.set_db(db)
        man = cc.WarmManifest(model_fp="test:tuning")
        pl, src = cc.aot_compile(lambda: L.launch_plan(128, 64, 512, F32), manifest=man,
                                 kind="test:tuning", signature="s")
        assert src == "compile" and pl.split == 4
        blob = man.to_bytes()
        # the restart: a fresh manifest object and emptied plan caches
        tuning.set_db(db)
        man2 = cc.WarmManifest.from_bytes(blob)
        cc0, tu0 = dict(cc.event_counts()), dict(_events())
        pl2, src2 = cc.aot_compile(lambda: L.launch_plan(128, 64, 512, F32), manifest=man2,
                                   kind="test:tuning", signature="s")
        assert src2 == "manifest" and pl2 == pl
        cc1, tu1 = cc.event_counts(), _events()
        assert cc1.get("hit", 0) - cc0.get("hit", 0) == 1
        assert cc1.get("capture", 0) - cc0.get("capture", 0) == 1
        assert cc1.get("miss", 0) == cc0.get("miss", 0)
        assert tu1 == tu0  # no tuning lookup on the warm path

    def test_db_refresh_invalidates_stale_manifest(self):
        telemetry.enable()
        db = tuning.TuningDB()
        db.record("lstm", (128, 64, 512), F32, {"variant": "step_cluster", "split": 4})
        tuning.set_db(db)
        man = cc.WarmManifest(model_fp="test:tuning")
        _, src = cc.aot_compile(lambda: L.launch_plan(128, 64, 512, F32), manifest=man,
                                kind="test:tuning", signature="s")
        assert src == "compile"
        db.record("lstm", (128, 64, 512), F32, {"variant": "step_cluster", "split": 8})
        pl, src2 = cc.aot_compile(lambda: L.launch_plan(128, 64, 512, F32), manifest=man,
                                  kind="test:tuning", signature="s")
        assert src2 == "compile" and pl.split == 8


# ---------------------------------------------------------------------------
# tune drivers + CLI (the plain versions on the CPU)
# ---------------------------------------------------------------------------

class TestTuneDrivers:
    def test_tune_attention_records_winner(self):
        telemetry.enable()
        db = tuning.TuningDB()
        cfg = {"backend": "flash", "variant": "f32_3xtf32_wgmma"}
        s = ttune.tune_attention(db, b=1, t=64, h=2, d=16, device="cpu", iters=2, reps=1,
                                 include_plain=False, candidates=[cfg])
        assert s["winner"] == cfg and s["default_config"] == cfg and s["default_valid"]
        assert s["rejected_parity"] == 0 and len(db) == 1 and not s["raised"]
        assert db.lookup("attention", (1, 64, 2, 16), F32) == cfg

    def test_tune_attention_with_the_naive_candidate_sets_the_verdict(self):
        db = tuning.TuningDB()
        s = ttune.tune_attention(db, b=1, t=64, h=2, d=16, device="cpu", iters=2, reps=1,
                                 candidates=[{"backend": "flash",
                                              "variant": "f32_3xtf32_wgmma"},
                                             {"backend": "plain"}])
        assert s["timed"] == 2
        tuning.set_db(db)
        shape = (1, 64, 2, 16)
        assert TA.resolve_attention(shape, shape, None, F32) == \
            (s["winner"]["backend"] == "flash")

    @pytest.mark.parametrize("kernel", ["conv_matmul", "conv3x3", "lstm"])
    def test_smoke_presets_record_a_gated_winner(self, kernel):
        telemetry.enable()
        db = tuning.TuningDB()
        s = ttune.KERNELS[kernel](db, device="cpu", **ttune.SMOKE_PRESETS[kernel])
        assert s["winner"] in ttune.SMOKE_PRESETS[kernel]["candidates"]
        assert s["rejected_parity"] == 0 and not s["raised"] and len(db) == 1
        assert _events().get("tune") == 1

    def test_the_default_is_a_timed_candidate(self):
        db = tuning.TuningDB()
        s = ttune.tune_lstm(db, t=4, b=2, hidden=16, device="cpu", iters=1, reps=1)
        assert s["default_valid"] and s["default_ms"] is not None
        assert s["enumerated"] == 7 and s["candidates"] + s["pruned_static"] == 7
        assert s["winner_ms"] <= s["default_ms"]

    def test_a_card_is_asked_for_by_default(self):
        if torch.cuda.is_available():
            pytest.skip("a card is present")
        with pytest.raises(RuntimeError, match="CUDA"):
            ttune.tune_lstm(tuning.TuningDB(), t=4, b=2, hidden=16)


class TestCLI:
    def test_tune_cli_smoke(self, tmp_path, capsys):
        from deeplearning4j_tpu_torch.cli import main
        p = str(tmp_path / "tuned.json")
        assert main(["tune", "--db", p, "--kernels", "attention", "--smoke", "--device",
                     "cpu"]) == 0
        doc = json.loads(open(p).read())
        assert doc["tuning_db_version"] == 1 and len(doc["entries"]) == 1
        out = capsys.readouterr().out
        assert "winner" in out and "tuning DB" in out

    def test_tune_cli_asks_for_the_card_even_with_smoke(self, tmp_path):
        from deeplearning4j_tpu_torch.cli import main
        if torch.cuda.is_available():
            pytest.skip("a card is present")
        with pytest.raises(RuntimeError, match="CUDA"):
            main(["tune", "--db", str(tmp_path / "t.json"), "--kernels", "lstm", "--smoke"])

    def test_a_cpu_run_on_a_card_host_never_reaches_the_card(self, tmp_path, monkeypatch):
        """On a host with a card, ``tune --device cpu`` times the plain
        versions: its winners key under the CPU's fingerprint, so the
        card's lookup misses them (they never replace card winners)."""
        from deeplearning4j_tpu_torch.cli import main
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        monkeypatch.setattr(torch.cuda, "get_device_capability", lambda i=0: (9, 0))
        monkeypatch.setattr(torch.cuda, "get_device_name", lambda i=0: "NVIDIA H100 80GB HBM3")
        card = cc.backend_fingerprint()
        assert card.endswith("/NVIDIA H100 80GB HBM3/sm_90")
        p = str(tmp_path / "tuned.json")
        db = tuning.TuningDB()
        db.record("lstm", (4, 2, 16), F32, {"variant": "persistent", "rt": 2}, device="cuda")
        db.save(p)
        assert main(["tune", "--db", p, "--kernels", "lstm", "--smoke", "--device",
                     "cpu"]) == 0
        got = tuning.TuningDB.load(p)
        assert got.lookup("lstm", (4, 2, 16), F32) == {"variant": "persistent", "rt": 2}
        assert sorted(k.rsplit("|", 1)[1] for k in got.entries) == sorted(
            [card, f"torch-{torch.__version__}/cpu"])

    def test_tune_cli_requires_db(self, monkeypatch):
        from deeplearning4j_tpu_torch.cli import main
        monkeypatch.delenv(tuning.ENV_DB, raising=False)
        with pytest.raises(SystemExit, match="no DB path"):
            main(["tune", "--smoke", "--device", "cpu"])

    def test_tune_cli_merges_existing(self, tmp_path):
        from deeplearning4j_tpu_torch.cli import main
        p = str(tmp_path / "tuned.json")
        assert main(["tune", "--db", p, "--kernels", "attention", "--smoke", "--device",
                     "cpu"]) == 0
        assert main(["tune", "--db", p, "--kernels", "conv_matmul", "--smoke", "--device",
                     "cpu"]) == 0
        doc = json.loads(open(p).read())
        assert {e["kernel"] for e in doc["entries"].values()} == {"attention", "conv_matmul"}
        # and the port's DB is one the JAX package's loader reads
        assert len(jtuning.TuningDB.load(p)) == 2


def test_recording_notes_each_distinct_plan_once():
    with _build.recording() as rec:
        for _ in range(3):
            L.launch_plan(128, 64, 512, F32)
        C.launch_plan(1, (2, 4, 4, 8), 16, (1, 1), F32)
    assert {k for k, _ in rec.plans} == {"lstm_seq", "conv_stats"} and len(rec.plans) == 2
