"""Train the weights of the ``cpnet`` configuration: the plain CPnet on the benchmark's scenes.

    python3 portbench/tools/train_cpnet.py --out portbench/fixtures/cpnet_cells.npz

The plain CPnet (``portbench/reference/cpnet.py``) at the configuration's
widths is trained on the card on 224x224 crops of 1024x1024 scenes drawn
as the benchmark draws its inputs (``scenes.cells_scene``, whose image is
``inputs.cells_frame``'s), stored as uint16 and normalized as a job of the
``flows_timelapse16`` mix normalizes (1st / 99th percentile), in grayscale
mode (a zero second channel). Targets: ``sequitr_tpu_torch.ops.flows.
flow_targets`` of each scene's instance map. Loss (Cellpose's): the mean
squared error of the flow channels against 5x the unit flows, halved, plus
the binary cross-entropy of the logit against the foreground. Random
flips of each crop (the flow components flipped with them); AdamW with a
cosine decay; bf16 autocast.

The batch-norm statistics are then the running ones (eval mode); the
weights are written in the flat layout (parameters float16, running
statistics float32). The written file is read back and the plain pipeline
(``reference/flows.py``: tiles, Hann stitch, 200 Euler steps, sink
grouping) scored on held-out scenes by AP at IoU 0.5 against the drawn
instances. Prints one JSON line: the file's sha256, the recipe and the
AP, which the configuration's ``weights`` block records.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import math
import os
import sys
import time
from multiprocessing import Pool

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
SHAPE = (1024, 1024)
CROP = 224
# the mix the weights serve: flows_timelapse16's params
SERVE = {"patch": [224, 224], "overlap": [64, 64], "p_lo": 1.0, "p_hi": 99.0, "n_iter": 200,
         "cellprob_threshold": 0.5}


def _scene(seed):
    """One scene's normalized frame, instance map and targets (5x flows,
    foreground)."""
    from portbench import scenes
    from portbench.reference import flows as flows_ref
    from sequitr_tpu_torch.ops import flows as flows_ops

    img, inst = scenes.cells_scene(seed, SHAPE)
    stored = img.clip(0, 65535).astype(np.uint16)
    flow, prob = flows_ops.flow_targets(inst)
    x = flows_ref.normalize(stored, SERVE["p_lo"], SERVE["p_hi"])
    return stored, x, inst, np.moveaxis(flow, -1, 0) * 5.0, prob


def _dense(inst: np.ndarray) -> np.ndarray:
    ids = np.unique(inst[inst > 0])
    remap = np.zeros(int(inst.max()) + 1, np.int64)
    remap[ids] = np.arange(1, ids.size + 1)
    return remap[inst]


def _param_dtype(key: str):
    return np.float32 if key.startswith("state/") else np.float16


def to_flat(net) -> dict:
    """The plain CPnet's weights in the flat layout ``reference/cpnet.py``
    reads (parameters float16, running statistics float32)."""
    from portbench.reference import cpnet as cpnet_ref

    flat = {}

    def seq(m, path):
        bn, conv = m[0], m[-1]
        flat[f"{path}/bn/scale"] = bn.weight
        flat[f"{path}/bn/bias"] = bn.bias
        flat[f"state/{path}/bn/mean"] = bn.running_mean
        flat[f"state/{path}/bn/var"] = bn.running_var
        flat[f"{path}/conv/w"] = conv.weight.permute(2, 3, 1, 0)  # OIHW -> HWIO
        flat[f"{path}/conv/b"] = conv.bias

    for kind, blocks in (("down", net.down), ("up", net.up)):
        for n, blk in enumerate(blocks):
            seq(blk.proj, f"{kind}/{n}/proj")
            for t, m in enumerate(blk.conv):
                path = f"{kind}/{n}/conv{t}"
                if isinstance(m, cpnet_ref.batchconvstyle):
                    seq(m.conv, path)
                    flat[f"{path}/full/w"] = m.full.weight.t()
                    flat[f"{path}/full/b"] = m.full.bias
                else:
                    seq(m, path)
    seq(net.output, "output")
    return {k: np.ascontiguousarray(v.detach().float().cpu().numpy()).astype(_param_dtype(k))
            for k, v in flat.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", required=True)
    ap.add_argument("--config", default="portbench/configs/cpnet_cellpose.json")
    ap.add_argument("--scenes", type=int, default=48)
    ap.add_argument("--holdout", type=int, default=8)
    ap.add_argument("--steps", type=int, default=3000)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--workers", type=int, default=6)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch
    import torch.nn.functional as F

    from portbench.reference import cpnet as cpnet_ref
    from portbench.reference import flows as flows_ref

    with open(os.path.join(ROOT, args.config)) as f:
        model = json.load(f)["model"]
    device = torch.device(args.device)
    t0 = time.perf_counter()
    seeds = [[args.seed, 1, k] for k in range(args.scenes)]
    held = [[args.seed, 2, k] for k in range(args.holdout)]
    with Pool(args.workers) as pool:
        train = pool.map(_scene, seeds)
        test = pool.map(_scene, held)
    x = torch.from_numpy(np.stack([s[1] for s in train])).to(device)
    flow = torch.from_numpy(np.stack([s[3] for s in train])).to(device)
    fg = torch.from_numpy(np.stack([s[4] for s in train])).to(device)
    t_data = time.perf_counter() - t0

    torch.manual_seed(args.seed)
    net = cpnet_ref.CPnet(model["nbase"], int(model["nout"]), int(model["sz"])).to(device)
    net.train()
    opt = torch.optim.AdamW(net.parameters(), lr=args.lr, weight_decay=1e-5)
    gen = torch.Generator(device="cpu").manual_seed(args.seed)
    t1 = time.perf_counter()
    losses = []
    for step in range(args.steps):
        lr = args.lr * 0.5 * (1 + math.cos(math.pi * step / args.steps))
        for g in opt.param_groups:
            g["lr"] = lr
        k = torch.randint(0, args.scenes, (args.batch,), generator=gen)
        oy = torch.randint(0, SHAPE[0] - CROP + 1, (args.batch,), generator=gen)
        ox = torch.randint(0, SHAPE[1] - CROP + 1, (args.batch,), generator=gen)
        flips = torch.randint(0, 2, (args.batch, 2), generator=gen)
        xs, fs, ps = [], [], []
        for i in range(args.batch):
            sl = (slice(int(oy[i]), int(oy[i]) + CROP), slice(int(ox[i]), int(ox[i]) + CROP))
            xi, fi, pi = x[int(k[i])][sl], flow[int(k[i])][(slice(None),) + sl].clone(), fg[int(k[i])][sl]
            for ax in (0, 1):
                if flips[i, ax]:
                    xi, pi = xi.flip(ax), pi.flip(ax)
                    fi = fi.flip(ax + 1)
                    fi[ax] = -fi[ax]
            xs.append(xi)
            fs.append(fi)
            ps.append(pi)
        xb = torch.stack(xs)[:, None]
        xb = torch.cat([xb, torch.zeros_like(xb)], dim=1)
        fb, pb = torch.stack(fs), torch.stack(ps)
        with torch.autocast("cuda", dtype=torch.bfloat16, enabled=device.type == "cuda"):
            y = net(xb)[0]
        y = y.float()
        loss = F.mse_loss(y[:, :2], fb) / 2 + F.binary_cross_entropy_with_logits(y[:, 2], pb)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        if step % 100 == 0 or step == args.steps - 1:
            losses.append([step, round(float(loss.detach()), 5)])
            print(f"step {step} loss {float(loss.detach()):.5f}", file=sys.stderr, flush=True)
    t_train = time.perf_counter() - t1

    net.eval()
    flat = to_flat(net)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    np.savez(args.out, **flat)
    with open(args.out, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()
    with np.load(args.out) as z:
        back = cpnet_ref.load({k: z[k] for k in z.files}, model, device)
    tp = n_t = n_p = 0
    per_frame = []
    for stored, _, inst, _, _ in test:
        pred = flows_ref.instances(back, stored, SERVE, device)
        a, b, c, _ = flows_ref.match(_dense(inst), pred)
        tp, n_t, n_p = tp + a, n_t + b, n_p + c
        per_frame.append(round(a / max(b + c - a, 1), 4))
    print(json.dumps({
        "path": os.path.relpath(os.path.abspath(args.out), ROOT), "sha256": digest,
        "bytes": os.path.getsize(args.out),
        "recipe": {"scenes": args.scenes, "scene_seeds": f"[{args.seed}, 1, k]", "crop": CROP,
                   "batch": args.batch, "steps": args.steps, "lr": f"{args.lr} cosine, AdamW",
                   "weight_decay": 1e-5, "augment": "flips", "autocast": "bfloat16",
                   "loss": "MSE(flow, 5 x unit flow) / 2 + BCE(logit, foreground)"},
        "holdout": {"scenes": args.holdout, "scene_seeds": f"[{args.seed}, 2, k]",
                    "ap50": round(tp / max(n_t + n_p - tp, 1), 4), "per_frame_ap50": per_frame,
                    "n_truth": n_t, "n_pred": n_p},
        "losses": losses, "data_s": round(t_data, 1), "train_s": round(t_train, 1),
        "device": torch.cuda.get_device_name(0) if device.type == "cuda" else "cpu",
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
