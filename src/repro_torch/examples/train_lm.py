"""End-to-end training: data pipeline -> model -> explicit-
threadcomm or spmd trainer -> checkpoints -> resume — the port of
``examples/train_lm.py``.

Presets:
  demo (default): ~13M-param llama-style LM, a few hundred steps in
                  minutes — loss visibly decreases on the structured
                  synthetic stream.
  100m:           ~124M params (the e2e scale).

The mesh is pod 2 x data 2 x model 2, every rank on the one device (the
port's rank-stacked threadcomm in the place of the reference's fake
host devices). Checkpoints go under the checkout's git-ignored
``build/train_lm`` unless ``--ckpt-dir`` says otherwise.

Run:  PYTHONPATH=src python -m repro_torch.examples.train_lm
          [--preset demo] [--steps 200] [--grad-sync threadcomm|flat|spmd]
          [--resume] [--device cpu]
"""

from __future__ import annotations

import argparse
import math
import os
import time

import torch

from repro_torch.config import MeshConfig, ModelConfig, ServeConfig, TrainConfig
from repro_torch.data import SyntheticPipeline
from repro_torch.examples import report, reset_counts
from repro_torch.launch.mesh import make_mesh_from_config
from repro_torch.models.registry import build_model
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.explicit import init_explicit_state
from repro_torch.train.trainer import init_train_state, make_train_step

PRESETS = {
    "demo": dict(num_layers=4, d_model=256, num_heads=4, num_kv_heads=2,
                 head_dim=64, d_ff=1024, vocab_size=4096,
                 batch=8, seq=128),
    "100m": dict(num_layers=12, d_model=640, num_heads=10, num_kv_heads=5,
                 head_dim=64, d_ff=2560, vocab_size=32000,
                 batch=16, seq=512),
}

CKPT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                        "build", "train_lm")


def main(argv=None):
    ap = argparse.ArgumentParser(description="end-to-end training")
    ap.add_argument("--preset", default="demo", choices=list(PRESETS))
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--grad-sync", default="threadcomm",
                    choices=["spmd", "threadcomm", "flat"])
    ap.add_argument("--ckpt-dir", default=CKPT_DIR)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    reset_counts()

    p = PRESETS[args.preset]
    cfg = ModelConfig(
        name=f"llama-{args.preset}", family="dense", block="dense",
        num_layers=p["num_layers"], d_model=p["d_model"],
        num_heads=p["num_heads"], num_kv_heads=p["num_kv_heads"],
        head_dim=p["head_dim"], d_ff=p["d_ff"], vocab_size=p["vocab_size"])
    print(f"model: {cfg.name}  params={cfg.param_count() / 1e6:.1f}M")

    mesh_cfg = MeshConfig(shape=(2, 2, 2),
                          axis_names=("pod", "data", "model"),
                          process_axes=("pod",))
    mesh = make_mesh_from_config(mesh_cfg, device=args.device)
    dev = mesh.device
    tcfg = TrainConfig(param_dtype="float32", compute_dtype="float32",
                       learning_rate=3e-3, warmup_steps=20,
                       total_steps=max(args.steps, 100),
                       grad_sync=args.grad_sync, remat=False, loss_chunk=64,
                       attn_chunk_threshold=256)
    model = build_model(cfg, ServeConfig(), device=dev, train=tcfg)
    pipe = SyntheticPipeline(cfg, batch=p["batch"], seq_len=p["seq"], seed=0)

    if args.grad_sync == "spmd":
        state = init_train_state(model, 0)
        step_fn = make_train_step(model, mesh_cfg, tcfg)
    else:
        state = init_explicit_state(model, 0, dp=mesh_cfg.dp)
        step_fn = make_train_step(model, mesh_cfg, tcfg, mesh=mesh)

    start = 0
    if args.resume and ckpt.latest_step(args.ckpt_dir) is not None:
        state, start, extra = ckpt.restore(args.ckpt_dir, state)
        print(f"resumed from step {start}")

    t0 = time.time()
    losses = []
    for i in range(start, args.steps):
        batch = {k: torch.as_tensor(v, device=dev)
                 for k, v in pipe.get_batch(i).items()}
        state, metrics = step_fn(state, batch)
        losses.append(float(metrics["loss"]))
        if i % 10 == 0 or i == args.steps - 1:
            print(f"step {i:4d}  loss {losses[-1]:.4f}  "
                  f"gnorm {float(metrics['grad_norm']):.3f}  "
                  f"({(time.time() - t0):.1f}s)")
        if (i + 1) % args.ckpt_every == 0:
            ckpt.save(args.ckpt_dir, i + 1, state,
                      extra=pipe.state_dict(i + 1), keep=2)
    print("final loss:", losses[-1] if losses else None)
    checks = {"finite": all(math.isfinite(x) for x in losses)}
    if len(losses) >= 2:
        checks["decreasing"] = losses[-1] < losses[0]
    return dict(report("train_lm", checks), losses=losses)


if __name__ == "__main__":
    main()
