"""Kuka IK debugger (counterpart of srl_tpu/envs/debug.py): command a
Cartesian fingertip target, and the damped-least-squares IK and joint servo
of ``ops/kinematics.py`` track it. Each command prints the joint vector and
the tip error, and with ``--out`` writes the rendered scene (a PNG when
matplotlib is installed, else a ``.npy`` array), traced by the render3d
kernel on a card.

Usage:
    python -m srl_tpu_torch.envs.debug --target 0.4 0.1 0.35 --steps 200 \\
        --out kuka_debug                 # single shot + frame
    python -m srl_tpu_torch.envs.debug --interactive
        > 0.4 0.1 0.35                   # one target per line
        > q
"""
from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

from srl_tpu_torch.core.device import resolve_device
from srl_tpu_torch.ops import kinematics as kin
from srl_tpu_torch.utils.logging import printGreen, printYellow


def track(q, target, steps: int = 200):
    """Servo the arm from ``q`` [7] toward the fingertip ``target`` [3];
    returns (q, tip, |tip - target|). ``control_step`` drives the flange,
    which with the enforced down orientation sits TIP_OFFSET above the
    fingertip, so the flange is sent that much higher."""
    q = torch.as_tensor(q, dtype=torch.float32)[None]
    target = torch.as_tensor(target, dtype=torch.float32, device=q.device)[None]
    flange_target = target + torch.tensor([0.0, 0.0, kin.TIP_OFFSET], device=q.device)
    for _ in range(steps):
        q = kin.control_step(q, flange_target)
    tip = kin.tip_position(q)
    return q[0], tip[0], float(torch.linalg.norm(tip - target))


def render_frame(q, out_path: str, device="cuda") -> str:
    """Render KukaButtonGymEnv-v0 (224x224) with the arm at ``q`` on
    ``device``; returns the path written."""
    from srl_tpu_torch.envs.kuka import KukaButtonEnv

    dev = resolve_device(device)
    env = KukaButtonEnv(srl_model="raw_pixels")
    state = env.reset(torch.Generator(device=dev).manual_seed(0), 1)
    state.q = torch.as_tensor(q, dtype=torch.float32, device=dev)[None].clone()
    frame = env.render_pixels(state)[0].cpu().numpy()
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        plt.imsave(out_path, frame)
        return out_path
    except ImportError:
        np.save(out_path + ".npy", frame)
        return out_path + ".npy"


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--target", nargs=3, type=float, default=None,
                        help="fingertip xyz target")
    parser.add_argument("--steps", type=int, default=200, help="servo steps per command")
    parser.add_argument("--out", default=None, help="directory for the rendered frames")
    parser.add_argument("--interactive", action="store_true",
                        help="read targets from stdin, one 'x y z' per line")
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = parser.parse_args(argv)
    dev = resolve_device(args.device)

    q = torch.as_tensor(kin.settled_rest_q(), device=dev)
    tip = kin.tip_position(q[None])[0]
    printGreen(f"rest pose tip: {np.round(tip.cpu().numpy(), 4).tolist()}")
    frame_idx = 0
    errors = []

    def run(target):
        nonlocal q, frame_idx
        q, tip, err = track(q, target, steps=args.steps)
        printGreen(f"target {np.round(target, 3).tolist()} -> tip "
                   f"{np.round(tip.cpu().numpy(), 4).tolist()}  |err|={err:.4f}")
        print("q:", np.round(q.cpu().numpy(), 4).tolist())
        if args.out:
            os.makedirs(args.out, exist_ok=True)
            path = render_frame(q, os.path.join(args.out, f"frame{frame_idx:03d}.png"), dev)
            printGreen(f"wrote {path}")
            frame_idx += 1
        errors.append(err)

    if args.target is not None:
        run(np.asarray(args.target, np.float32))
    if args.interactive:
        printYellow("enter 'x y z' targets, 'q' to quit")
        for line in sys.stdin:
            line = line.strip()
            if line in ("q", "quit", "exit", ""):
                break
            try:
                run(np.asarray([float(v) for v in line.split()], np.float32))
            except ValueError:
                printYellow("expected: x y z")
    return errors


if __name__ == "__main__":
    main()
