"""Data-parallel ranks for the CPU tests: each rank is a fresh interpreter
that imports torch and the port only (no JAX), joins a gloo group through a
``file://`` store in the test's own directory (no TCP port, so no race
between xdist workers), runs one job and saves its result with
``torch.save``.

    python tests/torch_dp_workers.py <job> <rank> <world> <workdir>

``Ranks`` starts the ranks (a test may work while they run) and ``join``
waits for them, ``JOIN_TIMEOUT_S`` at most (``launch`` does both): a rank
that hangs (a collective that some rank never reaches) is killed and the
test fails with every rank's log, instead of running the suite into its
limit.  The jobs read ``<workdir>/spec.pt`` (written by the test) and
write ``<workdir>/out_<rank>.pt``.
"""

from __future__ import annotations

import os
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
JOIN_TIMEOUT_S = 120.0


class Ranks:
    """``world`` ranks of ``job``, started in ``workdir`` on construction;
    ``join`` waits for them with the time limit and returns each rank's
    result."""

    def __init__(self, job: str, workdir, world: int, spec: dict | None):
        import torch

        self.job, self.workdir, self.world = job, Path(workdir), world
        self.workdir.mkdir(parents=True, exist_ok=True)
        if spec is not None:
            torch.save(spec, self.workdir / "spec.pt")
        (self.workdir / "store").unlink(missing_ok=True)  # a store left by an earlier launch
        env = {**os.environ, "PYTHONPATH": os.pathsep.join([str(REPO), str(REPO / "tests")]),
               "OMP_NUM_THREADS": "1"}
        self.procs, self.logs = [], []
        for rank in range(world):
            log = open(self.workdir / f"log_{rank}.txt", "w")
            self.logs.append(log)
            self.procs.append(subprocess.Popen(
                [sys.executable, __file__, job, str(rank), str(world), str(self.workdir)],
                cwd=REPO, env=env, stdout=log, stderr=subprocess.STDOUT))

    def join(self) -> list[dict]:
        import torch

        deadline = time.monotonic() + JOIN_TIMEOUT_S
        try:
            for p in self.procs:
                p.wait(timeout=max(deadline - time.monotonic(), 0.1))
        except subprocess.TimeoutExpired:
            pass
        finally:
            hung = [p for p in self.procs if p.poll() is None]
            for p in hung:
                p.kill()
            for p in self.procs:
                p.wait()
            for log in self.logs:
                log.close()
        if hung or any(p.returncode for p in self.procs):
            what = f"killed after {JOIN_TIMEOUT_S:.0f} s" if hung else "failed"
            raise AssertionError(f"{self.job} on {self.world} ranks {what}:\n" + "\n".join(
                f"--- rank {r} (exit {p.returncode}) ---\n"
                + (self.workdir / f"log_{r}.txt").read_text()[-4000:]
                for r, p in enumerate(self.procs)))
        return [torch.load(self.workdir / f"out_{r}.pt", weights_only=False)
                for r in range(self.world)]


def launch(job: str, workdir, world: int = 2, spec: dict | None = None) -> list[dict]:
    """Run ``job`` on ``world`` ranks and return each rank's result."""
    return Ranks(job, workdir, world, spec).join()


# ------------------------------------------------------------------ jobs


def job_collectives(mesh, spec: dict) -> dict:
    """``all_gather_with_grad``, ``global_sent_loss``, ``sharded_word_scores``,
    the global-batch ``_batch_norm`` and ``mismatch_pairs`` on this rank's
    rows of the spec's global inputs; gradients as the rank's own (before
    the data-parallel mean) and divided by the world size."""
    import torch

    from xmc_gan_tpu_torch.models.concept_gan import _batch_norm
    from xmc_gan_tpu_torch.parallel import collectives as col

    t = {k: torch.as_tensor(v) for k, v in spec.items() if k != "args"}
    n_loc = t["img"].shape[0] // mesh.world
    rows = mesh.rows(n_loc)
    out: dict = {}

    x = t["img"][rows].clone().requires_grad_(True)
    g = col.all_gather_with_grad(x, mesh)
    (g * t["gather_cot"]).sum().backward()
    out["gather"], out["gather_grad"] = g.detach(), x.grad

    x = t["img"][rows].clone().requires_grad_(True)
    loss = col.global_sent_loss(x, t["txt"][rows], t["sent"][rows], *spec["args"]["sent"], mesh)
    loss.backward()
    out["sent_loss"], out["sent_grad"] = loss.detach(), x.grad / mesh.world

    n_loc = t["regions"].shape[0] // mesh.world
    rows = mesh.rows(n_loc)
    r = t["regions"][rows].clone().requires_grad_(True)
    w = t["words"][rows].clone().requires_grad_(True)
    s = col.sharded_word_scores(r, w, t["mask"][rows], mesh, 4.0, 5.0, block_elems=64)
    val = (s * t["word_cot"]).sum()
    val.backward()
    out["scores"], out["word_val"] = s.detach(), val.detach()
    out["d_regions"], out["d_words"] = r.grad / mesh.world, w.grad / mesh.world

    n_loc = t["bn_x"].shape[0] // mesh.world
    rows = mesh.rows(n_loc)
    x = t["bn_x"][rows].clone().requires_grad_(True)
    scale, bias = t["bn_scale"].clone().requires_grad_(True), t["bn_bias"].clone()
    y = _batch_norm(x, scale, bias, mesh=mesh)
    (y * t["bn_cot"][rows]).sum().backward()
    out["bn"], out["bn_dx"], out["bn_dscale"] = y.detach(), x.grad, scale.grad

    n_loc = t["rmis_feats"].shape[0] // mesh.world
    rows = mesh.rows(n_loc)
    f, p, pairs = col.mismatch_pairs(t["rmis_feats"][rows], t["rmis_sent"][rows], mesh)
    out["rmis"] = (f, p, pairs)
    return out


def job_step(mesh, spec: dict) -> dict:
    """``spec["steps"]`` DP train steps of ``spec["cfg"]`` from the spec's G and D,
    each rank on its rows of the spec's batches and noise.  Returns the
    metrics of each step and the final G and D state dicts."""
    import torch

    from xmc_gan_tpu_torch import train
    from xmc_gan_tpu_torch.config import cfg_from_dict, cfg_from_file
    from xmc_gan_tpu_torch.parallel import replicate, shard_batch

    cfg = cfg_from_dict(spec["overrides"], base=cfg_from_file(spec["cfg"]))
    state = train.create_train_state(cfg, device="cpu", g_state_dict=spec["g"],
                                     d_state_dict=spec["d"])
    replicate(mesh, state)
    step = train.make_train_step(cfg, word_block_elems=spec.get("word_block_elems"), mesh=mesh)
    metrics = []
    for batch, noise in zip(spec["batches"], spec["noises"]):
        local = shard_batch(mesh, {**batch, "noise": noise})
        m = step(state, local, local.pop("noise"))
        metrics.append({k: float(v) for k, v in m.items()})
    return {"metrics": metrics,
            "g": {k: v.clone() for k, v in state.g.state_dict().items()},
            "d": {k: v.clone() for k, v in state.d.state_dict().items()}}


def job_trainer(mesh, spec: dict) -> dict:
    """``Trainer.fit`` of ``spec["overrides"]`` on synthetic data (CPU) for
    ``spec["epochs"]`` epochs with epoch checkpoints and auto-checkpoints;
    then a fresh ``Trainer`` of the same run resumes from the auto-checkpoint
    of step ``spec["resume_step"]`` (the newer ones deleted) and trains to the
    same end; then the FID statistics of the first run's G over the test
    split, all-reduced and this rank's own."""
    from xmc_gan_tpu_torch.config import cfg_from_dict
    from xmc_gan_tpu_torch.eval import FidComputer, evaluate_fid
    from xmc_gan_tpu_torch.parallel import barrier
    from xmc_gan_tpu_torch.trainer import Trainer

    cfg = cfg_from_dict(spec["overrides"])
    kw = dict(seed=spec["seed"], output_root=spec["root"], log_type="none", synthetic=True,
              synthetic_len=spec["synthetic_len"], num_threads=1, device="cpu", mesh=mesh,
              save_after=0, eval_fid=False, save_every_steps=spec["save_every_steps"])

    def snapshot(tr):
        return {"g": {k: v.clone() for k, v in tr.state.g.state_dict().items()},
                "d": {k: v.clone() for k, v in tr.state.d.state_dict().items()},
                "step": tr.state.step}

    tr = Trainer(cfg, **kw)
    out = {"fit": tr.fit(max_epochs=spec["epochs"]), "state": snapshot(tr),
           "auto_steps": tr.auto_ckpt.all_epochs(), "epochs": tr.ckpt.all_epochs()}
    barrier(mesh)  # every rank has listed the files before rank 0 deletes some
    if mesh.rank == 0:
        for step in tr.auto_ckpt.all_epochs():
            if step > spec["resume_step"]:
                os.unlink(tr.auto_ckpt.path(step))
    barrier(mesh)
    tr2 = Trainer(cfg, **kw)
    out["resumed_at"] = tr2.resume_latest_auto()
    out["resumed_fit"] = tr2.fit(max_epochs=spec["epochs"])
    out["resumed"] = snapshot(tr2)

    fid = FidComputer(device="cpu")
    stats = {}

    def capture(real, fake):
        stats["real"], stats["fake"] = real.finalize(), fake.finalize()
        stats["fake_local"] = (fake.n, fake._sum.clone(), fake._outer.clone())
        return 0.0

    fid.fid = capture
    evaluate_fid(cfg, tr.state.g, tr.encode, tr.test_loader, num_samples=spec["fid_samples"],
                 seed=0, fid=fid, mesh=mesh)
    out["fid_stats"] = stats
    return out


def main(argv: list[str]) -> int:
    import torch

    torch.set_num_threads(1)
    from xmc_gan_tpu_torch.parallel import make_mesh, shutdown

    job, rank, world, workdir = argv[0], int(argv[1]), int(argv[2]), Path(argv[3])
    mesh = make_mesh(world, device="cpu", init_method=f"file://{workdir / 'store'}",
                     rank=rank, world_size=world)
    spec = torch.load(workdir / "spec.pt", weights_only=False)
    try:
        out = globals()[f"job_{job}"](mesh, spec)
        torch.save(out, workdir / f"out_{rank}.pt")
    finally:
        shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
