"""Command-line interface: ``python -m sequitr_tpu_torch <command>``.

Commands (the ported part of ``python -m sequitr_tpu``'s surface):
  serve         — run the watched-directory image server on ``--device``
                  (default ``cuda``; ``cpu`` must be asked for)
  submit        — file a job JSON (or a workflow list) into a jobs directory
  status        — print a job's status (+ live progress; --follow tails it)
  import-model  — register a flat npz of weights, as written by
                  ``python -m sequitr_tpu export-model``, as a served model
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys
import time


def _follow_job(output_dir: str, poll: float, expect_id=None) -> int:
    """Live-tail a job: one line per progress update, final status, exit
    code from the terminal state. ``expect_id``: ignore status/progress rows
    of OTHER runs into the same output dir."""
    path = os.path.join(output_dir, "status.json")
    ppath = os.path.join(output_dir, "progress.json")
    last_update = None
    waiting_noted = False
    while True:
        try:
            with open(path) as f:
                status = json.load(f)
        except (OSError, ValueError):
            status = None  # not started yet (or mid-write)
        if (
            status is not None and expect_id is not None
            and status.get("id") != expect_id
        ):
            status = None  # a PREVIOUS run's marker: keep waiting
        if status is None and not waiting_noted:
            print(
                f"waiting for {path} (job not started yet, or wrong "
                "output dir?)", file=sys.stderr,
            )
            waiting_noted = True
        try:
            with open(ppath) as f:
                prog = json.load(f)
        except (OSError, ValueError):
            prog = None
        if prog and expect_id is not None and prog.get("id") != expect_id:
            prog = None
        if prog and prog.get("updated") != last_update:
            last_update = prog.get("updated")
            phase = prog.get("phase", "frames")
            line = f"{phase} {prog.get('done', 0)}"
            if prog.get("total") is not None:
                line += f"/{prog['total']}"
            rate = prog.get(f"{phase}_per_sec")
            if rate is not None:
                line += f"  ({rate}/s)"
            print(line, flush=True)
        state = (status or {}).get("state")
        if state in ("complete", "failed", "cancelled"):
            print(json.dumps(status, indent=2))
            return 0 if state == "complete" else 1
        time.sleep(poll)


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="sequitr_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    ap_serve = sub.add_parser("serve", help="run the image server")
    ap_serve.add_argument("--config", help="ServerConfiguration JSON path")
    ap_serve.add_argument("--jobs-dir", default="./jobs")
    ap_serve.add_argument("--models-dir", default="./models")
    ap_serve.add_argument("--poll-interval", type=float, default=1.0)
    ap_serve.add_argument(
        "--device", default=None,
        help="torch device jobs run on: cuda (default) or cpu; overrides"
             " the --config file's device",
    )

    ap_submit = sub.add_parser(
        "submit",
        help="submit a job JSON — or a WORKFLOW (a JSON list of specs, "
             "each auto-chained on the previous step's output dir)",
    )
    ap_submit.add_argument("--jobs-dir", default="./jobs")
    ap_submit.add_argument("spec", help="job spec JSON file (or '-' for stdin)")
    ap_submit.add_argument(
        "--follow", action="store_true",
        help="after submitting, live-tail the (last) job; exit 0 = complete",
    )
    ap_submit.add_argument(
        "--after", action="append", metavar="OUTPUT_DIR",
        help="run only after this output dir holds a complete status.json"
             " (repeatable)",
    )

    ap_status = sub.add_parser("status", help="read a job output status")
    ap_status.add_argument("output_dir")
    ap_status.add_argument("--follow", action="store_true")
    ap_status.add_argument("--poll", type=float, default=1.0)

    ap_imp = sub.add_parser(
        "import-model",
        help="register a flat npz of weights (python -m sequitr_tpu"
             " export-model output) as a served model",
    )
    ap_imp.add_argument("--models-dir", default="./models")
    ap_imp.add_argument("--npz", required=True, help="flat npz of weights")
    ap_imp.add_argument(
        "--arch", required=True,
        help="architecture JSON: num_classes/depth/base_features/... (a JAX"
             " model directory's config.json works as it is)",
    )
    ap_imp.add_argument(
        "--kind", default=None,
        help="model kind (unet, n2v, flows, stars, gan); default: the"
             " arch JSON's __kind__, else unet",
    )
    ap_imp.add_argument("name", help="model name to register")
    return ap


def main(argv=None) -> int:
    # install the drain-flag handler before anything slow, so a SIGUSR1
    # that arrives while the process boots is not lost
    early_drain = {"drain": False}
    try:
        import signal as _signal

        _signal.signal(
            _signal.SIGUSR1, lambda s, f: early_drain.update(drain=True)
        )
    except (ValueError, OSError, AttributeError):
        pass  # non-main thread or platform without SIGUSR1

    args = _parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s %(message)s")

    if args.cmd == "serve":
        from sequitr_tpu_torch.config import ServerConfiguration
        from sequitr_tpu_torch.server import ImageServer

        if args.config:
            cfg = ServerConfiguration.from_json(args.config)
        else:
            cfg = ServerConfiguration(
                jobs_dir=args.jobs_dir,
                models_dir=args.models_dir,
                poll_interval=args.poll_interval,
            )
        if args.device:
            cfg.device = args.device
        ImageServer(cfg).run_forever(early_drain=early_drain)
        return 0

    if args.cmd == "submit":
        from sequitr_tpu_torch.server import submit_job

        if args.spec == "-":
            spec = json.load(sys.stdin)
        else:
            with open(args.spec) as f:
                spec = json.load(f)
        specs = spec if isinstance(spec, list) else [spec]
        if not specs or not all(isinstance(s, dict) for s in specs):
            print(
                "spec must be a JSON object or a non-empty list of them",
                file=sys.stderr,
            )
            return 1
        for i, s in enumerate(specs):
            if i > 0 and "depends_on" not in s:
                prev_out = specs[i - 1].get("output")
                if not prev_out:
                    print(
                        f"workflow step {i - 1} needs an 'output' dir for "
                        f"step {i} to chain on (or give step {i} an "
                        f"explicit depends_on)",
                        file=sys.stderr,
                    )
                    return 1
                s["depends_on"] = str(prev_out)
        if args.after:
            deps = specs[0].get("depends_on") or []
            if isinstance(deps, str):
                deps = [deps]
            specs[0]["depends_on"] = list(deps) + list(args.after)
        if args.follow and not specs[-1].get("output"):
            print(
                "--follow needs an 'output' dir in the (last) spec to tail",
                file=sys.stderr,
            )
            return 1
        job_id = None
        for s in specs:
            job_id = submit_job(args.jobs_dir, s)
            print(job_id)
        if args.follow:
            return _follow_job(str(specs[-1]["output"]), 1.0, expect_id=job_id)
        return 0

    if args.cmd == "status":
        if args.follow:
            return _follow_job(args.output_dir, args.poll)
        path = os.path.join(args.output_dir, "status.json")
        with open(path) as f:
            text = f.read()
        print(text)
        ppath = os.path.join(args.output_dir, "progress.json")
        try:
            if json.loads(text).get("state") == "running" and os.path.exists(ppath):
                with open(ppath) as f:
                    print(f.read())
        except ValueError:
            pass
        return 0

    if args.cmd == "import-model":
        import numpy as np

        from sequitr_tpu_torch.models import convert as convert_lib
        from sequitr_tpu_torch.server.server import config_from_arch, save_model

        with open(args.arch) as f:
            arch = json.load(f)
        kind = args.kind or arch.get("__kind__", "unet")
        cfg = config_from_arch(kind, arch)
        with np.load(args.npz) as npz:
            flat = {k: npz[k] for k in npz.files}
        norm = cfg.gen_norm if kind == "gan" else cfg.norm
        if norm == "batch" and not any(k.startswith("state/") for k in flat):
            print(
                "npz carries no state/ entries: batch-norm running statistics"
                " are required (export with python -m sequitr_tpu"
                " export-model, which includes them)", file=sys.stderr,
            )
            return 1
        model = convert_lib.load_flat(cfg, flat, device="cpu")
        print(save_model(args.models_dir, args.name, kind, cfg, model))
        return 0

    return 1


if __name__ == "__main__":
    try:
        sys.exit(main())
    except BrokenPipeError:
        # downstream pipe closed early — exit quietly like unix tools
        os.dup2(os.open(os.devnull, os.O_WRONLY), sys.stdout.fileno())
        sys.exit(0)
