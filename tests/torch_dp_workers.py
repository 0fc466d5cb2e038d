"""Data- and tensor-parallel ranks for the CPU tests: each rank is a fresh
interpreter that imports torch and the port only (no JAX), joins a gloo
group through a ``file://`` store in the test's own directory (no TCP port,
so no race between xdist workers) as a ``dp x tp`` mesh (``spec["tp"]``,
default 1), runs one job and saves its result with ``torch.save``.

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

import numpy as np

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


def job_tp_collectives(mesh, spec: dict) -> dict:
    """On a ``dp x tp`` mesh: ``sharded_word_scores``' column blocks on this
    rank's rows of the spec's global inputs (scores, value, and the
    gradients divided by dp, the data-parallel mean); with
    ``spec["sn_conv"]``, a column-parallel spectral-normalized ``SNConv``
    beside the same layer whole: output, input gradient with
    ``create_graph``, and the weight and bias gradients of a MAGP-style
    penalty on it plus the value (the whole layer's weight gradient cut to
    this rank's rows)."""
    import torch

    from xmc_gan_tpu_torch.ops.modules import SNConv
    from xmc_gan_tpu_torch.parallel import collectives as col
    from xmc_gan_tpu_torch.parallel import shard_model
    from xmc_gan_tpu_torch.train import refresh_spectral

    t = {k: torch.as_tensor(v) for k, v in spec.items() if isinstance(v, np.ndarray)}
    rows = mesh.rows(t["regions"].shape[0] // mesh.dp)
    r = t["regions"][rows].clone().requires_grad_(True)
    w = t["words"][rows].clone().requires_grad_(True)
    s = col.sharded_word_scores(r, w, t["mask"][rows], mesh, 4.0, 5.0, block_elems=32)
    val = (s * t["word_cot"]).sum()
    val.backward()
    out = {"scores": s.detach(), "word_val": val.detach(), "d_regions": r.grad / mesh.dp,
           "d_words": w.grad / mesh.dp, "data_rank": mesh.data_rank}
    from xmc_gan_tpu_torch.parallel.tensor import _summed

    # a bf16 sum over the model group: each rank's part is rank-dependent
    part = (t["conv_x"] * (mesh.model_rank + 1) / 3).bfloat16()
    part = part.contiguous(memory_format=torch.channels_last)
    out["bf16_sum"] = (part, _summed(part, mesh))
    if spec.get("sn_conv"):
        layers = []
        for _ in range(2):
            layer = SNConv(6, 8, 3, padding=1, spec_norm=True,
                           gen=torch.Generator().manual_seed(1))
            refresh_spectral(layer, 3)
            layers.append(layer)
        shard_model(layers[1], mesh, tp_min_size=layers[1].weight.numel())
        res = []
        for layer in layers:
            x = t["conv_x"].clone().contiguous(memory_format=torch.channels_last)
            x.requires_grad_(True)
            y = layer(x)
            v = (y * t["conv_cot"]).sum()
            (gx,) = torch.autograd.grad(v, x, create_graph=True)
            pen = gx.square().sum().pow(1.5)
            gw, gb = torch.autograd.grad(pen + v, [layer.weight, layer.bias])
            res.append({"y": y.detach(), "gx": gx.detach(), "gw": gw, "gb": gb})
        res[0]["gw"] = layers[1].shard.take(res[0]["gw"])
        refresh_spectral(layers[0], 2)
        refresh_spectral(layers[1], 2)
        for layer, r_ in zip(layers, res):
            r_["u"], r_["v"] = layer.weight_u.clone(), layer.weight_v.clone()
        out["sn_conv"] = {"whole": res[0], "split": res[1]}
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


def job_tp_step(mesh, spec: dict) -> dict:
    """``job_step`` on a ``dp x tp`` mesh: the state split by
    ``shard_state`` at ``spec["tp_min_size"]``.  Returns the metrics, this
    rank's own G and D state dicts (its weight shards) and the whole state
    (``gather_state``), with the names of the split weights."""
    from xmc_gan_tpu_torch import train
    from xmc_gan_tpu_torch.config import cfg_from_dict, cfg_from_file
    from xmc_gan_tpu_torch.parallel import gather_state, replicate, shard_batch, shard_state
    from xmc_gan_tpu_torch.parallel.tensor import _sharded_layers

    cfg = cfg_from_dict(spec["overrides"], base=cfg_from_file(spec["cfg"]))
    state = train.create_train_state(cfg, device="cpu", g_state_dict=spec["g"],
                                     d_state_dict=spec["d"])
    replicate(mesh, state)
    shard_state(state, mesh, spec["tp_min_size"])
    step = train.make_train_step(cfg, word_block_elems=spec.get("word_block_elems"), mesh=mesh)
    metrics = []
    for batch, noise in zip(spec["batches"], spec["noises"]):
        local = shard_batch(mesh, {**batch, "noise": noise})
        m = step(state, local, local.pop("noise"))
        metrics.append({k: float(v) for k, v in m.items()})
    whole = gather_state(state)
    return {"metrics": metrics, "data_rank": mesh.data_rank, "model_rank": mesh.model_rank,
            "local": {n: {k: v.clone() for k, v in net.state_dict().items()}
                      for n, net in (("g", state.g), ("d", state.d))},
            "split": {n: sorted(f"{k}.weight" for k in _sharded_layers(net))
                      for n, net in (("g", state.g), ("d", state.d))},
            "moments": {n: [tuple(s["exp_avg"].shape) for s in opt.state.values()]
                        for n, opt in (("g", state.g_opt), ("d", state.d_opt))},
            "g": whole["g"], "d": whole["d"]}


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


def job_tp_trainer(mesh, spec: dict) -> dict:
    """``Trainer.fit`` on a ``dp x tp`` mesh for one epoch (its checkpoint written by rank 0, the whole state), the FID
    of its split G on every rank; then a fresh ``Trainer`` resumes the
    one-process checkpoint under ``spec["one_root"]``.  Returns the fit's
    metrics, the FID, and both whole states (``gather_state``)."""
    from xmc_gan_tpu_torch.config import cfg_from_dict
    from xmc_gan_tpu_torch.eval import FidComputer, evaluate_fid
    from xmc_gan_tpu_torch.parallel import gather_state
    from xmc_gan_tpu_torch.trainer import Trainer

    cfg = cfg_from_dict(spec["overrides"])
    kw = dict(seed=spec["seed"], log_type="none", synthetic=True,
              synthetic_len=spec["synthetic_len"], num_threads=1, device="cpu", mesh=mesh,
              save_after=0, eval_fid=False)
    tr = Trainer(cfg, output_root=spec["root"], watch=True, **kw)  # watch: a gather an epoch
    out = {"fit": tr.fit(max_epochs=1), "state": gather_state(tr.state),
           "fid": evaluate_fid(cfg, tr.state.g, tr.encode, tr.test_loader,
                               num_samples=spec["fid_samples"], seed=0,
                               fid=FidComputer(device="cpu"), mesh=mesh)}
    tr2 = Trainer(cfg, output_root=spec["one_root"], **kw)
    out["resumed_at"] = tr2.resume(1)
    out["resumed"] = gather_state(tr2.state)
    return out


def main(argv: list[str]) -> int:
    import torch

    torch.set_num_threads(1)
    from xmc_gan_tpu_torch.parallel import make_mesh, shutdown

    job, rank, world, workdir = argv[0], int(argv[1]), int(argv[2]), Path(argv[3])
    spec = torch.load(workdir / "spec.pt", weights_only=False)
    tp = spec.get("tp", 1)
    mesh = make_mesh(world // tp, tp, device="cpu", init_method=f"file://{workdir / 'store'}",
                     rank=rank, world_size=world)
    try:
        out = globals()[f"job_{job}"](mesh, spec)
        torch.save(out, workdir / f"out_{rank}.pt")
    finally:
        shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
