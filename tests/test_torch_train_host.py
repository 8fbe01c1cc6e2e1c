"""The training port's host code against the JAX package on the CPU.

``SyntheticLM`` batches bit for bit for the three frontends (tokens,
audio frames, vision patches) and ``Prefetcher``'s order and ``close``;
``assign_shards`` and ``host_load_cv``; ``FailureDetector`` and
``elastic_plan`` on simulated clocks; ``WriterPool`` lanes, bytes and
``dispersion``; checkpoints across packages both ways (the reference
writes a ``TrainState`` and the port restores it, and the reverse),
with a ``.tmp`` directory never restored, a bad crc32 raising and
``keep=3`` collection; a ``Trainer`` killed after step 4 and resumed to
step 6 bit for bit the uninterrupted run; ``launch.train`` (its fit
check too) and the three ``examples_torch`` scripts with ``--device
cpu`` at smoke sizes.
"""

import importlib.util
import json
import shutil
from pathlib import Path

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.ckpt import CheckpointManager as JCkpt  # noqa: E402
from repro.ckpt import WriterPool as JPool  # noqa: E402
from repro.config import get_smoke_arch as jarch  # noqa: E402
from repro.data import SyntheticLM as JSynth  # noqa: E402
from repro.data import assign_shards as jassign  # noqa: E402
from repro.data import host_load_cv as jcv  # noqa: E402
from repro.ft import FailureDetector as JDetector  # noqa: E402
from repro.ft import elastic_plan as jplan  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro.train.step import TrainState as JState  # noqa: E402

from repro_torch import convert, models  # noqa: E402
from repro_torch.ckpt import CheckpointManager, WriterPool  # noqa: E402
from repro_torch.ckpt.checkpoint import load_params  # noqa: E402
from repro_torch.config import RunConfig, get_arch, get_smoke_arch  # noqa
from repro_torch.data import (Prefetcher, SyntheticLM,  # noqa: E402
                              assign_shards, host_load_cv)
from repro_torch.ft import FailureDetector, elastic_plan  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.train.step import TrainState, init_train_state  # noqa
from repro_torch.train.trainer import Trainer, TrainerConfig  # noqa: E402
from repro_torch.utils import tree_flatten_with_names  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("arch", ["smollm-360m", "musicgen-large",
                                  "llava-next-mistral-7b"])
def test_synthetic_batches_are_bitwise_the_reference(arch):
    j = JSynth(jarch(arch), 3, 24, seed=5, host=1, num_hosts=2)
    t = SyntheticLM(get_smoke_arch(arch), 3, 24, seed=5, host=1,
                    num_hosts=2)
    for step in (0, 1, 17):
        want, got = j.batch_at(step), t.batch_at(step)
        assert sorted(want) == sorted(got)
        for k in want:
            assert want[k].dtype == got[k].dtype
            np.testing.assert_array_equal(got[k], want[k])


def test_prefetcher_keeps_order_and_closes():
    src = SyntheticLM(get_smoke_arch("smollm-360m"), 2, 8, seed=1)
    pf = Prefetcher(src, start_step=7, depth=2)
    for want in range(7, 12):
        step, batch = next(pf)
        assert step == want
        np.testing.assert_array_equal(batch["tokens"],
                                      src.batch_at(want)["tokens"])
    pf.close()
    assert not pf._t.is_alive()


@pytest.mark.parametrize("policy", ["midas", "round_robin", "hash"])
def test_assign_shards_matches_reference(policy):
    rng = np.random.default_rng(0)
    sizes = [int(x) for x in rng.pareto(1.2, 100) * 1e6 + 1e5]
    for hosts in (4, 7):
        want = jassign(sizes, hosts, policy=policy, d=3)
        got = assign_shards(sizes, hosts, policy=policy, d=3)
        assert got == want
        assert host_load_cv(sizes, got, hosts) == jcv(sizes, want, hosts)


def test_failure_detector_and_elastic_plan_match_reference():
    j, t = JDetector(4, timeout_s=5.0, now=0.0), FailureDetector(
        4, timeout_s=5.0, now=0.0)
    beats = [(0, 1.0, 1.0), (1, 1.2, 1.1), (2, 3.5, 1.3), (0, 1.0, 2.0),
             (1, 1.1, 2.3), (2, 3.9, 2.9), (3, 1.0, 3.0), (0, 0.9, 6.0)]
    for host, dt, now in beats:
        j.heartbeat(host, step_time_s=dt, now=now)
        t.heartbeat(host, step_time_s=dt, now=now)
        for clock in (now, now + 4.0, now + 9.0):
            assert t.failed(clock) == j.failed(clock)
        assert t.stragglers() == j.stragglers()
        assert [h.ewma_step for h in t.hosts.values()] == \
            [h.ewma_step for h in j.hosts.values()]
    for old, alive in ((8, {0, 1, 2, 3, 4, 5, 6, 7}), (8, {0, 2, 5}),
                       (4, set()), (16, set(range(11)))):
        assert elastic_plan(old, alive) == jplan(old, alive)
        assert elastic_plan(old, alive, min_hosts=4) == jplan(
            old, alive, min_hosts=4)


@pytest.mark.parametrize("policy", ["midas", "round_robin", "hash"])
def test_writer_pool_lanes_match_reference(policy, tmp_path):
    """Lane for lane on the same names and sizes.  The steering reads
    the live backlog, which the lanes' threads drain as they write, so
    every leaf is assigned before any is submitted (a save interleaves
    them, and its lanes then depend on how fast the writes go, in both
    packages); then the bytes each lane wrote and their dispersion."""
    rng = np.random.default_rng(3)
    leaves = [(f"blocks/{i}/w", rng.standard_normal(
        int(rng.integers(1, 400_000))).astype(np.float32))
        for i in range(40)]
    lanes = {}
    for name, pool in (("j", JPool(4, policy=policy)),
                       ("t", WriterPool(4, policy=policy))):
        d = tmp_path / name
        d.mkdir()
        got = [pool.assign(leaf, arr.nbytes) for leaf, arr in leaves]
        backlog = pool.backlogs()
        for i, (lane, (_, arr)) in enumerate(zip(got, leaves)):
            pool.submit(lane, d / f"{i}.npy", arr)
        pool.join()
        lanes[name] = (got, backlog, pool.lane_bytes(), pool.dispersion())
        if name == "t":
            pool.close()
            for i, (_, arr) in enumerate(leaves):
                np.testing.assert_array_equal(np.load(d / f"{i}.npy"), arr)
    assert lanes["t"] == lanes["j"]
    assert sum(lanes["t"][2]) == sum(a.nbytes for _, a in leaves)
    if policy == "midas":  # it steered
        assert len(set(lanes["t"][0])) == 4


def _jax_state(cfg, eight_bit):
    """A reference TrainState (numpy leaves) with the port's weights."""
    params = convert.params_to_numpy(models.init_params(cfg, 1,
                                                        device="cpu"))
    opt = jax.device_get(jax.jit(lambda p: jopt.init_adam_state(
        p, eight_bit=eight_bit))(params))
    moe = convert.moe_state_to_numpy(models.init_moe_state(cfg, "cpu"))
    return JState(params=params, opt=opt, moe_state=moe,
                  step=np.asarray(7, np.int32))


@pytest.mark.parametrize("eight_bit", [False, True])
def test_checkpoints_cross_between_the_packages(eight_bit, tmp_path):
    """The reference writes, the port restores (and loads its weights
    to serve); the port writes, the reference restores: every leaf bit
    for bit; the manifests' leaves,
    shapes, dtypes, checksums and file numbers the same."""
    cfg = get_smoke_arch("qwen3-moe-235b-a22b")
    jst = _jax_state(cfg, eight_bit)
    run = RunConfig(optimizer="adamw8bit" if eight_bit else "adamw")
    target = init_train_state(cfg, run, 0, device="cpu")
    JCkpt(str(tmp_path / "j"), lanes=4).save(7, jst)
    step, restored = CheckpointManager(str(tmp_path / "j")).restore_latest(
        target)
    assert step == 7
    want = dict(tree_flatten_with_names(jst))
    got = tree_flatten_with_names(convert.tree_from_numpy(restored, "cpu"))
    assert [n for n, _ in got] == list(want)
    for name, leaf in got:
        np.testing.assert_array_equal(leaf.numpy(), want[name])

    # serving loads the reference's checkpoint's weights
    model = load_params(str(tmp_path / "j"), cfg, device="cpu")
    for (n, a), (m, b) in zip(
            tree_flatten_with_names(convert.params_to_numpy(model)),
            tree_flatten_with_names(jst.params)):
        assert n == m
        np.testing.assert_array_equal(a, b)

    port_state = convert.tree_from_numpy(jst, "cpu")
    port_state = TrainState(*port_state)
    cm = CheckpointManager(str(tmp_path / "t"), lanes=4)
    cm.save(7, port_state, blocking=False).result()
    cm.close()
    step, back = JCkpt(str(tmp_path / "t")).restore_latest(jst)
    assert step == 7
    for (n, a), (m, b) in zip(tree_flatten_with_names(back),
                              tree_flatten_with_names(jst)):
        assert n == m
        np.testing.assert_array_equal(np.asarray(a), b)
    # the manifests agree but for the lanes, which follow the live
    # backlog as the writes drain it (test_writer_pool_lanes_match_...)
    mj = json.loads((tmp_path / "j/step_00000007/manifest.json").read_text())
    mt = json.loads((tmp_path / "t/step_00000007/manifest.json").read_text())
    assert list(mt["leaves"]) == list(mj["leaves"])
    for name, meta in mj["leaves"].items():
        other = mt["leaves"][name]
        assert {k: other[k] for k in ("shape", "dtype", "crc32")} == \
            {k: meta[k] for k in ("shape", "dtype", "crc32")}
        assert other["file"] == f"lane{other['lane']}/" + \
            meta["file"].split("/")[1]
    assert sum(mt["lane_bytes"]) == sum(mj["lane_bytes"])


def test_checkpoint_tmp_crc_and_garbage_collection(tmp_path):
    tree = {"a": np.arange(10, dtype=np.float32),
            "b": {"c": np.ones((3, 4), np.int8)}}
    cm = CheckpointManager(str(tmp_path), lanes=2, keep=3)
    for step in (1, 2, 3, 4, 5):
        cm.save(step, tree)
    assert cm.all_steps() == [3, 4, 5]
    # a crashed save: a .tmp directory is never restored
    shutil.copytree(tmp_path / "step_00000005", tmp_path / "step_00000009.tmp")
    assert cm.latest_step() == 5
    _, out = cm.restore_latest(tree)
    np.testing.assert_array_equal(out["a"], tree["a"])
    # a flipped byte fails its checksum
    meta = json.loads((tmp_path / "step_00000005/manifest.json").read_text())
    path = tmp_path / "step_00000005" / meta["leaves"]["a"]["file"]
    raw = bytearray(path.read_bytes())
    raw[-1] ^= 0xFF
    path.write_bytes(bytes(raw))
    with pytest.raises(IOError, match="checksum"):
        cm.restore(5, tree)
    with pytest.raises(ValueError, match="shape"):
        cm.restore(4, {"a": np.zeros(3, np.float32), "b": tree["b"]})
    with pytest.raises(KeyError, match="missing"):
        cm.restore(4, dict(tree, z=np.zeros(1)))
    cm.close()


def test_trainer_kill_and_resume_is_bitwise(tmp_path):
    """4 steps with a checkpoint every 2 (asynchronous, MIDAS lanes), the
    process gone, then a new Trainer resumes to 6: every leaf of its
    state equals an uninterrupted 6-step run's."""
    cfg = get_smoke_arch("smollm-360m")
    run = RunConfig()
    logs = []

    def trainer(steps, ckpt):
        tc = TrainerConfig(steps=steps, batch=2, seq=16, ckpt_every=2,
                           ckpt_dir=ckpt, log_every=2, seed=3)
        return Trainer(cfg, run, tc, log_fn=logs.append, device="cpu")

    whole = trainer(6, None).train()
    t = trainer(4, str(tmp_path))
    t.train()
    t.close()
    assert CheckpointManager(str(tmp_path)).all_steps() == [2, 4]
    t = trainer(6, str(tmp_path))
    resumed = t.train()
    t.close()
    assert "[trainer] resumed from checkpoint step 4" in logs
    assert any(line.startswith("[trainer] step     6 loss") for line in logs)
    assert int(resumed.step) == 6
    for (n, a), (m, b) in zip(tree_flatten_with_names(whole),
                              tree_flatten_with_names(resumed)):
        assert n == m and torch.equal(a, b), n


def _run_script(name, argv):
    path = ROOT / "examples_torch" / name
    spec = importlib.util.spec_from_file_location(path.stem, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.main(argv)


def test_launch_train_and_examples_run_on_the_cpu(tmp_path, capsys):
    trainer, state = launch_train.main([
        "--arch", "qwen3-moe-235b-a22b", "--steps", "2", "--batch", "2",
        "--seq", "16", "--device", "cpu", "--ckpt-dir", str(tmp_path),
        "--ckpt-every", "1", "--optimizer", "adamw8bit"])
    assert int(state.step) == 2 and len(trainer.history) == 2
    assert "moe_drop_rate" in trainer.history[0]
    assert "done at step 2" in capsys.readouterr().out
    _run_script("train_lm.py", ["--device", "cpu", "--steps", "3",
                                "--batch", "2", "--seq", "16"])
    assert "finished at step 3" in capsys.readouterr().out
    _run_script("checkpoint_storm.py", ["--device", "cpu"])
    out = capsys.readouterr().out
    assert out.count("crc32 verified") == 2
    _run_script("quickstart.py", ["--device", "cpu", "--T", "60"])
    assert "power_of_d" in capsys.readouterr().out


def test_launch_refuses_a_state_that_does_not_fit_one_card(monkeypatch):
    """The fit check names item 19 before anything is allocated; SmolLM
    fits an 80 GB card, Qwen3-MoE does not."""
    class Props:
        total_memory = 80 * 10**9

    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda dev: Props())
    card = torch.device("cuda")
    launch_train.check_fits(get_arch("smollm-360m"), "adamw", card)
    with pytest.raises(NotImplementedError, match="item 19"):
        launch_train.check_fits(get_arch("qwen3-moe-235b-a22b"), "adamw8bit",
                                card)
    assert launch_train.state_bytes(get_arch("smollm-360m"), "adamw") == \
        18 * sum(p.numel() for p in models.Model(
            get_arch("smollm-360m"), device="meta").parameters())
