"""Training launcher of the port: a config-driven entry point over the
trainer — the port of ``src/repro/launch/train.py``.

On the card it runs the published configs (``--layers N`` cuts the
depth of one too large for the card, every width as published); on the
CPU use ``--smoke --device cpu`` (reduced same-family configs) with a
small mesh, e.g.::

  PYTHONPATH=src python -m repro_torch.launch.train --arch yi-9b \\
      --smoke --device cpu --steps 6 --batch 8 --seq 32 --mesh 2,2,2 \\
      --grad-sync threadcomm

Every rank of a mesh runs on the one device (``core.compat``). The
entry point defaults to the card and raises without one.
"""

from __future__ import annotations

import argparse
import statistics
import time
from typing import Callable, Dict, Optional

import torch

from repro_torch.config import MeshConfig, ServeConfig, TrainConfig
from repro_torch.configs import ARCH_NAMES
from repro_torch.data import SyntheticPipeline
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import make_mesh_from_config
from repro_torch.launch.serve import arch_config
from repro_torch.models.registry import build_model
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.trainer import init_train_state, make_train_step


def mesh_config(mesh: str) -> MeshConfig:
    """``--mesh``: "1" one device, "D,M" data x model, "P,D,M" pod x data
    x model with the pod axis the process domain."""
    shape = tuple(int(x) for x in mesh.split(","))
    if shape == (1,):
        return MeshConfig(shape=(1,), axis_names=("data",))
    if len(shape) == 3:
        return MeshConfig(shape=shape, axis_names=("pod", "data", "model"),
                          process_axes=("pod",))
    return MeshConfig(shape=shape, axis_names=("data", "model"))


def run_train(arch: str, *, smoke: bool = False, steps: int = 100,
              batch: int = 8, seq: int = 128, mesh: str = "1",
              grad_sync: str = "spmd", lr: float = 3e-3,
              ckpt_dir: Optional[str] = None, ckpt_every: int = 50,
              resume: bool = False, device="cuda",
              layers: Optional[int] = None,
              step_wrapper: Optional[Callable] = None,
              log: Callable = print) -> Dict:
    """The launcher's run. Returns ``losses`` (one a step), ``step_s``
    (host wall clock of each step, the loss read back included),
    ``start`` (the first step, after a resume) and the configs.
    ``step_wrapper(i, thunk)`` runs step ``i``'s ``thunk`` (a caller's
    profiler)."""
    dev = resolve_device(device)
    cfg = arch_config(arch, smoke, layers)
    mesh_cfg = mesh_config(mesh)
    dm = (None if mesh_cfg.shape == (1,)
          else make_mesh_from_config(mesh_cfg, device=dev))
    dtype = "float32" if smoke else "bfloat16"
    tcfg = TrainConfig(param_dtype=dtype, compute_dtype=dtype,
                       learning_rate=lr, warmup_steps=10,
                       total_steps=max(steps, 100), grad_sync=grad_sync,
                       remat=not smoke, loss_chunk=min(64, seq),
                       attn_chunk_threshold=max(256, seq))
    model = build_model(cfg, ServeConfig(), device=dev, train=tcfg)
    log(f"arch={cfg.name} params={cfg.param_count() / 1e6:.1f}M "
        f"mesh={mesh_cfg.shape} grad_sync={grad_sync} device={dev}")

    pipe = SyntheticPipeline(cfg, batch=batch, seq_len=seq, seed=0)
    if grad_sync == "spmd" or dm is None:
        state = init_train_state(model, 0)
        step_fn = make_train_step(model, mesh_cfg, tcfg)
    else:
        from repro_torch.train.explicit import init_explicit_state
        state = init_explicit_state(model, 0, dp=mesh_cfg.dp)
        step_fn = make_train_step(model, mesh_cfg, tcfg, mesh=dm)

    start = 0
    if resume and ckpt_dir and ckpt.latest_step(ckpt_dir):
        state, start, _ = ckpt.restore(ckpt_dir, state)
        log(f"resumed at step {start}")

    losses, step_s = [], []
    t0 = time.time()
    for i in range(start, steps):
        b = {k: torch.as_tensor(v, device=dev)
             for k, v in pipe.get_batch(i).items()}
        ts = time.perf_counter()
        thunk = (lambda s=state, b=b: step_fn(s, b))
        state, metrics = (step_wrapper(i, thunk) if step_wrapper
                          else thunk())
        losses.append(float(metrics["loss"]))
        step_s.append(time.perf_counter() - ts)
        if i % 10 == 0 or i == steps - 1:
            log(f"step {i:5d} loss {losses[-1]:.4f} "
                f"({time.time() - t0:.1f}s)")
        if ckpt_dir and (i + 1) % ckpt_every == 0:
            ckpt.save(ckpt_dir, i + 1, state,
                      extra=pipe.state_dict(i + 1), keep=3)
    log("done.")
    return {"arch": cfg.name, "layers": cfg.num_layers,
            "params": cfg.param_count(), "mesh": mesh_cfg.shape,
            "grad_sync": grad_sync, "batch": batch, "seq": seq,
            "start": start, "losses": losses, "step_s": step_s,
            "median_step_s": (statistics.median(step_s) if step_s
                              else None)}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=list(ARCH_NAMES))
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--mesh", default="1",
                    help="comma mesh shape; 1=single device, "
                         "2,2,2=pod/data/model")
    ap.add_argument("--grad-sync", default="spmd",
                    choices=["spmd", "threadcomm", "flat"])
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the depth to the first N blocks")
    args = ap.parse_args(argv)
    run_train(args.arch, smoke=args.smoke, steps=args.steps,
              batch=args.batch, seq=args.seq, mesh=args.mesh,
              grad_sync=args.grad_sync, lr=args.lr, ckpt_dir=args.ckpt_dir,
              ckpt_every=args.ckpt_every, resume=args.resume,
              device=args.device, layers=args.layers)


if __name__ == "__main__":
    main()
