"""The port's checkpointing (``repro_torch.checkpoint``): atomic commit,
async writer, retention, exact resume, and the reference's on-disk layout
in both directions.

Mirrors ``tests/test_checkpoint.py``; its exact-resume test trains the LM
substrate, which is not ported, so the port's resumes the Cahn–Hilliard
solver instead.  The cross-package tests write with one package and read
with the other, bit for bit, leaf keys and dtypes included.
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import restore_pytree as ref_restore
from repro.checkpoint import save_pytree as ref_save
from repro_torch.checkpoint import (
    Checkpointer,
    latest_step,
    restore_pytree,
    save_pytree,
)
from repro_torch.checkpoint.checkpointer import _flatten
from repro_torch.core.cahn_hilliard import CahnHilliardADI, CHConfig


def tree(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "params": {
            "w": torch.as_tensor(rng.standard_normal((16, 8)), dtype=torch.float32),
            "b": torch.as_tensor(rng.standard_normal(8)).to(torch.bfloat16),
        },
        "step": torch.tensor(7, dtype=torch.int32),
    }


def _leaves(t):
    return [leaf for _, leaf in _flatten(t)]


class TestSaveRestore:
    def test_roundtrip_bitwise(self, tmp_path):
        t = tree()
        save_pytree(t, str(tmp_path), 7, metadata={"loss": 1.5})
        restored, manifest = restore_pytree(t, str(tmp_path))
        for a, b in zip(_leaves(t), _leaves(restored), strict=True):
            assert a.dtype == b.dtype
            assert torch.equal(a, b)
        assert manifest["step"] == 7
        assert manifest["metadata"]["loss"] == 1.5

    def test_latest_pointer_and_multiple_steps(self, tmp_path):
        t = tree()
        for s in (1, 5, 3):  # out-of-order saves; LATEST follows writes
            save_pytree(t, str(tmp_path), s)
        assert latest_step(str(tmp_path)) == 3
        _, manifest = restore_pytree(t, str(tmp_path), step=5)
        assert manifest["step"] == 5

    def test_shape_mismatch_rejected(self, tmp_path):
        save_pytree(tree(), str(tmp_path), 1)
        bad = tree()
        bad["params"]["w"] = torch.zeros((4, 4))
        with pytest.raises(ValueError):
            restore_pytree(bad, str(tmp_path))

    def test_missing_leaf_rejected(self, tmp_path):
        save_pytree(tree(), str(tmp_path), 1)
        bigger = tree()
        bigger["params"]["extra"] = torch.zeros(3)
        with pytest.raises(KeyError):
            restore_pytree(bigger, str(tmp_path))

    def test_no_partial_checkpoint_visible(self, tmp_path):
        save_pytree(tree(), str(tmp_path), 2)
        os.makedirs(tmp_path / "tmp.99.1234")  # simulated crash leftovers
        assert latest_step(str(tmp_path)) == 2
        _, m = restore_pytree(tree(), str(tmp_path))
        assert m["step"] == 2

    def test_restore_makes_fresh_tensors(self, tmp_path):
        t = {"c": torch.arange(6.0), "c_prev": torch.arange(6.0)}
        save_pytree(t, str(tmp_path), 1)
        r, _ = restore_pytree(t, str(tmp_path))
        r["c"].add_(1.0)  # a solver updates its carry in place
        assert torch.equal(r["c_prev"], torch.arange(6.0))
        assert torch.equal(t["c"], torch.arange(6.0))
        r2, _ = restore_pytree(t, str(tmp_path))
        assert torch.equal(r2["c"], torch.arange(6.0))


class TestCheckpointer:
    def test_async_save_and_gc(self, tmp_path):
        ckpt = Checkpointer(str(tmp_path), keep_last=2)
        for s in range(5):
            ckpt.save_async(tree(s), s, metadata={"loss": 5.0 - s})
        ckpt.wait()
        steps = sorted(
            int(n.split("_")[-1])
            for n in os.listdir(tmp_path)
            if n.startswith("step_")
        )
        assert steps == [3, 4]

    def test_save_async_snapshots_before_returning(self, tmp_path):
        """An in-place update right after ``save_async`` (the solver's next
        chunk) must not reach the checkpoint."""
        c = torch.arange(1000.0, dtype=torch.float64)
        ckpt = Checkpointer(str(tmp_path), keep_last=1)
        ckpt.save_async({"c": c}, 1)
        c.mul_(-1.0)
        ckpt.close()
        r, _ = restore_pytree({"c": c}, str(tmp_path))
        assert torch.equal(r["c"], torch.arange(1000.0, dtype=torch.float64))

    def test_keep_best(self, tmp_path):
        ckpt = Checkpointer(
            str(tmp_path), keep_last=1, keep_best=1, best_metric="loss"
        )
        losses = {0: 3.0, 1: 1.0, 2: 2.5}
        for s, loss in losses.items():
            ckpt.save_async(tree(s), s, metadata={"loss": loss})
            ckpt.wait()
        steps = {
            int(n.split("_")[-1])
            for n in os.listdir(tmp_path)
            if n.startswith("step_")
        }
        assert 1 in steps  # the best survived the GC
        assert 2 in steps  # the most recent survived

    def test_corrupt_latest_reads_as_no_checkpoint(self, tmp_path):
        save_pytree(tree(), str(tmp_path), 3)
        with open(tmp_path / "LATEST", "w") as f:
            f.write("not_a_step_name")
        assert latest_step(str(tmp_path)) is None
        with pytest.raises(FileNotFoundError):
            restore_pytree(tree(), str(tmp_path))
        # explicit step addressing still works around the corrupt pointer
        _, m = restore_pytree(tree(), str(tmp_path), step=3)
        assert m["step"] == 3

    def test_latest_pointing_at_missing_dir_raises(self, tmp_path):
        save_pytree(tree(), str(tmp_path), 1)
        with open(tmp_path / "LATEST", "w") as f:
            f.write("step_00000099")
        with pytest.raises(OSError):
            restore_pytree(tree(), str(tmp_path))

    def test_gc_reads_each_manifest_once(self, tmp_path, monkeypatch):
        ckpt = Checkpointer(
            str(tmp_path), keep_last=1, keep_best=1, best_metric="loss"
        )
        for s in range(4):
            ckpt.save_async(tree(s), s, metadata={"loss": float(s)})
        ckpt.wait()
        calls = []
        orig = Checkpointer._metric_of
        monkeypatch.setattr(
            Checkpointer,
            "_metric_of",
            lambda self, step: calls.append(step) or orig(self, step),
        )
        ckpt._gc()
        assert sorted(calls) == sorted(set(calls))

    def test_gc_tolerates_corrupt_manifest(self, tmp_path):
        ckpt = Checkpointer(
            str(tmp_path), keep_last=1, keep_best=2, best_metric="loss"
        )
        for s in range(3):
            ckpt.save_async(tree(s), s, metadata={"loss": 3.0 - s})
            ckpt.wait()
        with open(tmp_path / "step_00000001" / "manifest.json", "w") as f:
            f.write("{ torn write")
        ckpt._gc()  # unscored, not fatal
        survivors = {n for n in os.listdir(tmp_path) if n.startswith("step_")}
        assert "step_00000002" in survivors  # most recent kept regardless

    def test_writer_errors_surface_on_wait(self, tmp_path):
        ckpt = Checkpointer(str(tmp_path / "sub"), keep_last=1)
        # unpicklable leaf triggers a writer failure, surfaced on wait()
        ckpt._q.put(("save", {"bad": (lambda: 1)}, 0, None))
        with pytest.raises(BaseException):
            ckpt.wait()


class TestExactResume:
    def test_solver_resume_bit_exact(self, tmp_path):
        """8 steps straight == 4 steps, checkpoint, restore, 4 steps."""
        solver = CahnHilliardADI(CHConfig(nx=32, ny=32, device="cpu"))
        c0 = torch.as_tensor(np.random.default_rng(0).uniform(-0.1, 0.1, (32, 32)))
        c1 = solver.initial_step(c0)
        straight = solver.make_evolve(8)(c1.clone(), c0.clone())
        half = solver.make_evolve(4)(c1.clone(), c0.clone())
        template = {"c": c0, "c_prev": c0}
        save_pytree({"c": half[0], "c_prev": half[1]}, str(tmp_path), 5)
        r, _ = restore_pytree(template, str(tmp_path))
        resumed = solver.make_evolve(4)(r["c"], r["c_prev"])
        for a, b in zip(straight, resumed, strict=True):
            assert torch.equal(a, b)


class TestReferenceLayout:
    """State carries across the two packages, both ways, bit for bit."""

    def _nested(self, seed=0):
        rng = np.random.default_rng(seed)
        return {
            "z": [rng.standard_normal((3, 4)), (rng.standard_normal(5),
                                                 rng.standard_normal(())) ],
            "a": {"w": rng.standard_normal((2, 2)).astype(np.float32),
                  "k": np.arange(6, dtype=np.int32)},
        }

    def test_reference_checkpoint_restores_in_the_port(self, tmp_path):
        host = self._nested()
        jtree = {"z": [jnp.asarray(host["z"][0]),
                       (jnp.asarray(host["z"][1][0]), jnp.asarray(host["z"][1][1]))],
                 "a": {"w": jnp.asarray(host["a"]["w"]),
                       "k": jnp.asarray(host["a"]["k"]),
                       "h": jnp.asarray(host["a"]["w"], jnp.bfloat16)}}
        ref_save(jtree, str(tmp_path), 3, metadata={"mean": 0.25})
        template = {"z": [torch.zeros(3, 4), (torch.zeros(5), torch.zeros(()))],
                    "a": {"w": torch.zeros(2, 2), "k": torch.zeros(6),
                          "h": torch.zeros(2, 2)}}
        got, manifest = restore_pytree(template, str(tmp_path))
        assert manifest["metadata"] == {"mean": 0.25}
        assert torch.equal(got["z"][0], torch.as_tensor(host["z"][0]))
        assert torch.equal(got["z"][1][0], torch.as_tensor(host["z"][1][0]))
        assert torch.equal(got["z"][1][1], torch.as_tensor(host["z"][1][1]))
        assert got["a"]["w"].dtype == torch.float32
        assert torch.equal(got["a"]["w"], torch.as_tensor(host["a"]["w"]))
        assert got["a"]["k"].dtype == torch.int32
        assert got["a"]["h"].dtype == torch.bfloat16
        assert torch.equal(got["a"]["h"],
                           torch.as_tensor(host["a"]["w"]).to(torch.bfloat16))

    def test_port_checkpoint_restores_in_the_reference(self, tmp_path):
        host = self._nested(1)
        ttree = {"z": [torch.as_tensor(host["z"][0]),
                       (torch.as_tensor(host["z"][1][0]),
                        torch.as_tensor(host["z"][1][1]))],
                 "a": {"w": torch.as_tensor(host["a"]["w"]),
                       "k": torch.as_tensor(host["a"]["k"]),
                       "h": torch.as_tensor(host["a"]["w"]).to(torch.bfloat16)}}
        save_pytree(ttree, str(tmp_path), 12, metadata={"loss": 2.0})
        template = {"z": [jnp.zeros((3, 4)), (jnp.zeros(5), jnp.zeros(()))],
                    "a": {"w": jnp.zeros((2, 2)), "k": jnp.zeros(6),
                          "h": jnp.zeros((2, 2))}}
        got, manifest = ref_restore(template, str(tmp_path))
        assert manifest["step"] == 12 and manifest["metadata"] == {"loss": 2.0}
        np.testing.assert_array_equal(np.asarray(got["z"][0]), host["z"][0])
        np.testing.assert_array_equal(np.asarray(got["z"][1][0]), host["z"][1][0])
        np.testing.assert_array_equal(np.asarray(got["z"][1][1]), host["z"][1][1])
        assert np.asarray(got["a"]["w"]).dtype == np.float32
        np.testing.assert_array_equal(np.asarray(got["a"]["w"]), host["a"]["w"])
        np.testing.assert_array_equal(np.asarray(got["a"]["k"]), host["a"]["k"])
        assert str(got["a"]["h"].dtype) == "bfloat16"
        np.testing.assert_array_equal(
            np.asarray(got["a"]["h"], np.float32),
            torch.as_tensor(host["a"]["w"]).to(torch.bfloat16).float().numpy())

    def test_same_files_and_manifest_as_the_reference(self, tmp_path):
        host = self._nested(2)
        jtree = {"z": [jnp.asarray(host["z"][0]),
                       (jnp.asarray(host["z"][1][0]), jnp.asarray(host["z"][1][1]))],
                 "a": {"w": jnp.asarray(host["a"]["w"]),
                       "k": jnp.asarray(host["a"]["k"])}}
        ttree = {"z": [torch.as_tensor(host["z"][0]),
                       (torch.as_tensor(host["z"][1][0]),
                        torch.as_tensor(host["z"][1][1]))],
                 "a": {"w": torch.as_tensor(host["a"]["w"]),
                       "k": torch.as_tensor(host["a"]["k"])}}
        ref_dir = ref_save(jtree, str(tmp_path / "ref"), 4)
        port_dir = save_pytree(ttree, str(tmp_path / "port"), 4)
        assert os.path.basename(port_dir) == os.path.basename(ref_dir) == "step_00000004"
        assert sorted(os.listdir(port_dir)) == sorted(os.listdir(ref_dir))
        mr = json.load(open(os.path.join(ref_dir, "manifest.json")))
        mp = json.load(open(os.path.join(port_dir, "manifest.json")))
        assert mp["leaves"] == mr["leaves"]
        assert sorted(mr["leaves"]) == ["a.k", "a.w", "z.0", "z.1.0", "z.1.1"]
        for info in mr["leaves"].values():
            a = np.load(os.path.join(ref_dir, info["file"]))
            b = np.load(os.path.join(port_dir, info["file"]))
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        assert (open(tmp_path / "ref" / "LATEST").read()
                == open(tmp_path / "port" / "LATEST").read())
