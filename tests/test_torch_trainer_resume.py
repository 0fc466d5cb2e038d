"""The port's ``Trainer`` on the CPU: checkpoints, resume and preemption,
mirroring ``tests/test_trainer.py``.

Save -> resume gives a bitwise-equal state (parameters, D's power-iteration
buffers, both Adam states, the step); auto-checkpoints keep the newest two;
a mid-epoch crash resumed from its auto-checkpoint ends bit for bit where
the uninterrupted run does, with K = 1 and 2 steps a window; a resume with
no auto-checkpoint starts fresh; SIGTERM saves and resumes exactly, and the
previous handler is restored, also when ``fit`` raises; ``--watch`` logs
parameter and update histograms.  NCH 8, 64², batch 4, fp32, 16 synthetic
examples (4 steps an epoch).
"""

import os
import signal

import numpy as np
import pytest
import torch

from test_torch_trainer import Recorder, _overrides
from torch_port_helpers import one_torch_thread, small_cfgs
from xmc_gan_tpu_torch.trainer import Trainer


pytestmark = pytest.mark.usefixtures("one_torch_thread")
def _trainer(root, name, seed, **kw) -> Trainer:
    opts = dict(log_type="none", synthetic=True, synthetic_len=16, save_after=50,
                num_threads=1, eval_fid=False, device="cpu")
    cfg = small_cfgs(_overrides(word=kw.pop("word", False), n_critic=1))[1]
    return Trainer(cfg, seed=seed, output_root=str(root / name), **{**opts, **kw})


def _assert_states_equal(a, b):
    assert a.step == b.step
    for x, y in ((a.g, b.g), (a.d, b.d)):
        sa, sb = x.state_dict(), y.state_dict()
        assert set(sa) == set(sb)
        for k in sa:
            assert torch.equal(sa[k], sb[k]), k
    for x, y in ((a.g_opt, b.g_opt), (a.d_opt, b.d_opt)):
        oa, ob = x.state_dict(), y.state_dict()
        assert oa["param_groups"] == ob["param_groups"]
        assert set(oa["state"]) == set(ob["state"])
        for i in oa["state"]:
            for k, v in oa["state"][i].items():
                assert torch.equal(v, ob["state"][i][k]), (i, k)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return tmp_path_factory.mktemp("runs")


@pytest.fixture(scope="module")
def two_epochs(runs):
    """One word-loss run with every artifact on: 2 epochs of 4 steps,
    checkpoints at epochs 1 and 2, auto-checkpoints every 3 steps."""
    tr = _trainer(runs, "full", 5, word=True, save_after=0, save_every_steps=3, log_type="tb")
    return tr, tr.fit(max_epochs=2)


def test_fit_writes_the_run_layout(two_epochs):
    tr, metrics = two_epochs
    assert metrics and all(np.isfinite(v) for v in metrics.values())
    out = tr.output_dir
    for name in ("img/sents.txt", "img/imgs.png", "img/fake_samples_epoch_001.png",
                 "img/fake_samples_epoch_002.png", "log/log.txt"):
        assert os.path.isfile(f"{out}/{name}"), name
    assert any(n.startswith("events.out.tfevents") for n in os.listdir(f"{out}/log"))
    assert tr.ckpt.all_epochs() == [1, 2]
    assert tr.auto_ckpt.all_epochs() == [3, 6]  # steps 3 and 6 of 8; max_to_keep 2
    assert tr.state.step == tr.global_step == 8


def test_save_then_resume_is_bitwise(two_epochs, runs):
    tr, _ = two_epochs
    again = _trainer(runs, "full", 5, word=True, save_after=0, save_every_steps=3)
    assert again.resume() == 2 and again.global_step == 8
    _assert_states_equal(tr.state, again.state)
    assert again.resume(1) == 1 and again.state.step == 4


def test_auto_checkpoints_keep_the_newest_two(runs):
    tr = _trainer(runs, "auto", 9, save_every_steps=1)
    tr.fit(max_epochs=2)  # 8 steps
    assert tr.auto_ckpt.all_epochs() == [7, 8]
    again = _trainer(runs, "auto", 9, save_every_steps=1)
    assert again.resume_latest_auto() == 8 and again.state_epoch == 2
    _assert_states_equal(tr.state, again.state)


@pytest.mark.parametrize("k", [1, 2])
def test_mid_epoch_crash_resume_is_exact(k, runs):
    """A crash at step 2 of an epoch of 4, resumed from the auto-checkpoint:
    the loader skips the consumed batches and the noise is a function of the
    step, so the final state is the uninterrupted run's, bit for bit.  With
    K = 2 the windows (and auto-saves) fall on even steps."""
    kw = dict(save_every_steps=k, steps_per_dispatch=k)
    full = _trainer(runs, f"k{k}_full", 13, **kw)
    full.fit(max_epochs=1)
    assert full.state.step == 4 and full._multi_step_calls == (2 if k == 2 else 0)
    crashed = _trainer(runs, f"k{k}_crash", 13, **kw)
    crashed.fit(max_epochs=1, max_steps=2)
    resumed = _trainer(runs, f"k{k}_crash", 13, **kw)
    assert resumed.resume_latest_auto() == 2
    assert resumed._resume_skip == 2 and resumed.state_epoch == 0
    resumed.fit(max_epochs=1)
    _assert_states_equal(full.state, resumed.state)


def test_resume_auto_without_checkpoint_starts_fresh(runs):
    tr = _trainer(runs, "fresh", 23, save_every_steps=2)
    assert tr.resume_latest_auto() == 0
    assert tr.state_epoch == 0 and tr._resume_skip == 0 and tr.state.step == 0


class KillDuringFetch:
    """Sends SIGTERM to this process at the ``at``-th example read."""

    def __init__(self, ds, at):
        self._ds, self._at, self._n = ds, at, 0

    def __len__(self):
        return len(self._ds)

    def __getitem__(self, key):
        self._n += 1
        if self._n == self._at:
            os.kill(os.getpid(), signal.SIGTERM)
        return self._ds[key]


def test_sigterm_preemption_saves_and_resumes_exactly(runs):
    """SIGTERM mid-epoch saves an exact auto-checkpoint at the next window
    boundary and returns; resuming completes to the uninterrupted state bit
    for bit, the previous handler is back, and a retry on the same instance
    is not preempted by a stale flag."""
    kw = dict(save_every_steps=100)
    full = _trainer(runs, "pfull", 29, **kw)
    full.fit(max_epochs=1)
    orig = signal.getsignal(signal.SIGTERM)
    pre = _trainer(runs, "preempt", 29, **kw)
    pre.train_loader.dataset = KillDuringFetch(pre.train_loader.dataset, 6)  # batch 2 of 4
    pre.fit(max_epochs=1)
    saved = pre.auto_ckpt.all_epochs()
    assert saved and saved[-1] < 4
    assert signal.getsignal(signal.SIGTERM) is orig
    resumed = _trainer(runs, "preempt", 29, **kw)
    assert resumed.resume_latest_auto() == saved[-1]
    resumed.fit(max_epochs=1)
    _assert_states_equal(full.state, resumed.state)
    assert pre.resume_latest_auto() == saved[-1]
    pre.fit(max_epochs=1)
    _assert_states_equal(full.state, pre.state)


def test_sigterm_handler_restored_when_fit_raises(runs):
    tr = _trainer(runs, "raise", 31)
    orig = signal.getsignal(signal.SIGTERM)

    def boom(*a, **k):
        raise RuntimeError("boom")

    tr.step_fn = boom
    with pytest.raises(RuntimeError, match="boom"):
        tr.fit(max_epochs=1)
    assert signal.getsignal(signal.SIGTERM) is orig


def test_watch_logs_parameter_and_update_histograms(runs):
    tr = _trainer(runs, "watch", 5, watch=True)
    tr.writer = rec = Recorder()
    tr.fit(max_epochs=2)
    assert [step for step, _ in rec.hists] == [1, 2]
    first, second = rec.hists[0][1], rec.hists[1][1]
    assert any(k.startswith("parameters/netG/") for k in first)
    assert any(k.startswith("parameters/netD/") for k in first)
    assert all("." not in k and "[" not in k for k in first)
    assert not any(k.startswith("updates/") for k in first)
    upd = [k for k in second if k.startswith("updates/")]
    assert set(upd) == {f"updates/{k[len('parameters/'):]}" for k in first}
    total = sum(float(np.abs(second[k]).sum()) for k in upd)
    assert np.isfinite(total) and total > 0


def test_profile_dir_traces_the_chosen_steps(runs):
    """``profile_dir``: a Chrome trace of steps ``profile_steps`` (here 2 and
    3 of 4), written when the window closes; on the CPU it holds host
    events and no kernel."""
    from xmc_gan_tpu_torch.profiling import read_trace

    trace_dir = runs / "trace"
    tr = _trainer(runs, "profiled", 3, profile_dir=str(trace_dir), profile_steps=(1, 3))
    tr.fit(max_epochs=1)
    got = read_trace(str(trace_dir / "trace.json"))
    assert got["names"] == [] and got["launches"] == 0 and got["span_ms"] > 0
