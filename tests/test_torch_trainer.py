"""The port's ``Trainer`` (``repro_torch.train.loop``) on the CPU.

* ``tests/test_train_integration.py``'s scenario in float32 (the
  config's bf16 replaced): the reference's Trainer writes its step-0 state
  as a checkpoint, the port's Trainer restores it (the checkpoint format
  is the contract) and both train 20 steps; the loss histories agree
  within rel. 1e-4 at every step.
* The port's own mirrors of the reference's loss-decrease,
  resume-reproducibility and straggler cases.
* Elastic recovery, ``tests/test_multidevice.py``'s scenario on 8 logical
  CPU units in process (the units are logical, so no subprocess is
  needed): ``model_par=2``, master weights, two units lost at step 18;
  step 30 after one recovery, the final loss of an uninterrupted run, and
  a rescale onto 4 units restores step 30.
"""
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.data import DataConfig, SyntheticLM  # noqa: E402
from repro_torch.distributed.fault import FailureInjector, StragglerMonitor  # noqa: E402
from repro_torch.distributed.meshes import units  # noqa: E402
from repro_torch.models import Runtime, build_model  # noqa: E402
from repro_torch.optim import AdamW, AdamWConfig, WarmupCosine  # noqa: E402
from repro_torch.train.loop import Trainer, TrainerConfig  # noqa: E402
from torch_parity import one_torch_thread  # noqa: E402,F401


def make_trainer(ckpt_dir, steps, seed=0, horizon=20, dtype=None):
    cfg = reduced(get_config("granite-8b")).replace(vocab_size=512)
    if dtype:
        cfg = cfg.replace(dtype=dtype)
    model = build_model(cfg, Runtime(remat="none"))
    data = SyntheticLM(cfg, batch=4, seq_len=64, dcfg=DataConfig(seed=1))
    return Trainer(
        cfg, model, AdamW(AdamWConfig()),
        WarmupCosine(peak_lr=3e-3, warmup_steps=5, decay_steps=horizon),
        data,
        TrainerConfig(total_steps=steps, ckpt_every=10, ckpt_dir=ckpt_dir,
                      log_every=1000, seed=seed),
        device="cpu",
    )


def test_loss_history_matches_reference(tmp_path):
    from repro.configs import get_config as rget, reduced as rred
    from repro.data import DataConfig as RDC, SyntheticLM as RData
    from repro.models import Runtime as RRt, build_model as rbuild
    from repro.optim import AdamW as RA, AdamWConfig as RAC, WarmupCosine as RW
    from repro.train.loop import Trainer as RTrainer, TrainerConfig as RTC

    def ref_trainer(ckpt_dir, steps):
        cfg = rred(rget("granite-8b")).replace(vocab_size=512, dtype="float32")
        return RTrainer(cfg, rbuild(cfg, RRt(remat="none")), RA(RAC()),
                        RW(peak_lr=3e-3, warmup_steps=5, decay_steps=20),
                        RData(cfg, batch=4, seq_len=64, dcfg=RDC(seed=1)),
                        RTC(total_steps=steps, ckpt_every=10, ckpt_dir=ckpt_dir,
                            log_every=1000, seed=0))

    ref_trainer(str(tmp_path / "init"), 0).run()  # writes its step-0 state
    shutil.copytree(tmp_path / "init" / "step_0000000000", tmp_path / "port" / "step_0000000000")
    want = ref_trainer(str(tmp_path / "ref"), 20).run()
    got = make_trainer(str(tmp_path / "port"), 20, dtype="float32").run()
    assert got["final_step"] == want["final_step"] == 20
    wl = np.array([h["loss"] for h in want["history"]])
    gl = np.array([h["loss"] for h in got["history"]])
    assert len(gl) == len(wl) == 20
    np.testing.assert_allclose(gl, wl, rtol=1e-4)


def test_loss_decreases(tmp_path):
    out = make_trainer(str(tmp_path / "a"), 30, horizon=30).run()
    losses = [h["loss"] for h in out["history"]]
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.3


def test_checkpoint_resume_reproducible(tmp_path):
    full = make_trainer(str(tmp_path / "full"), 20).run()
    make_trainer(str(tmp_path / "resume"), 10).run()
    resumed = make_trainer(str(tmp_path / "resume"), 20).run()
    assert resumed["final_step"] == 20
    np.testing.assert_allclose(resumed["final_loss"], full["final_loss"], rtol=1e-5)


def test_trainer_runs_on_the_card_unless_asked_for_the_cpu(tmp_path, monkeypatch):
    """The Trainer's default device is the card: without one it raises,
    never a quiet CPU fallback."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = reduced(get_config("granite-8b"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(cfg, build_model(cfg), AdamW(), WarmupCosine(), SyntheticLM(cfg, 2, 8),
                TrainerConfig(total_steps=1, ckpt_dir=str(tmp_path)))


def test_elastic_recovery_on_logical_units(tmp_path):
    cfg = reduced(get_config("qwen3-32b")).replace(vocab_size=512)

    def trainer(tag, injector):
        return Trainer(
            cfg, build_model(cfg, Runtime(remat="none")),
            AdamW(AdamWConfig(master_weights=True)),
            WarmupCosine(peak_lr=2e-3, warmup_steps=3, decay_steps=30),
            SyntheticLM(cfg, batch=8, seq_len=32),
            TrainerConfig(total_steps=30, ckpt_every=8, ckpt_dir=str(tmp_path / tag),
                          log_every=1000),
            devices=units("cpu", count=8), model_par=2, failure_injector=injector,
            device="cpu")

    tr = trainer("fail", FailureInjector(schedule={18: 2}))
    out = tr.run()
    assert out["final_step"] == 30 and out["recoveries"] == 1
    assert tr.mesh.shape == {"data": 3, "model": 2}
    losses = [h["loss"] for h in out["history"]]
    assert losses[-1] < losses[0]
    full = trainer("full", None).run()
    np.testing.assert_allclose(out["final_loss"], full["final_loss"], rtol=1e-5)
    tr.rescale(units("cpu", count=8)[:4])
    state, step = tr._init_or_restore()
    assert step == 30 and tr.mesh.shape == {"data": 2, "model": 2}
    assert state["params"]["embed"].device.type == "cpu"


def test_straggler_monitor_fires():
    mon = StragglerMonitor(alpha=0.2, threshold=1.5, patience=2)
    fired = []
    mon.on_straggle = lambda step, ratio: fired.append((step, ratio))
    for i in range(10):
        mon.observe(i, 1.0)
    for i in range(10, 13):
        mon.observe(i, 3.0)
    assert fired and fired[0][0] >= 10
    assert mon.events


def test_straggler_monitor_ignores_single_spike():
    mon = StragglerMonitor(threshold=1.5, patience=3)
    for i in range(5):
        mon.observe(i, 1.0)
    assert not mon.observe(5, 5.0)
    assert not mon.events
