"""Keyboard teleoperation client (counterpart of
srl_tpu/real_robots/teleop.py; real_robots/teleop_client.py upstream).

Drives a robot server over the ZMQ protocol with the w/a/s/d keys from the
terminal (raw tty input, no OpenCV window).

Run:  python -m srl_tpu_torch.real_robots.teleop [--port 7777] [--continuous]
"""
from __future__ import annotations

import argparse
import sys

import numpy as np

from srl_tpu_torch.real_robots.transport import connect_pair, recvMatrix
from srl_tpu_torch.utils.logging import printGreen, printYellow

KEY_TO_DISCRETE = {
    "w": 0,  # FORWARD
    "s": 1,  # BACKWARD
    "a": 2,  # LEFT
    "d": 3,  # RIGHT
}
KEY_TO_CONTINUOUS = {
    "w": [0.05, 0.0],
    "s": [-0.05, 0.0],
    "a": [0.0, 0.05],
    "d": [0.0, -0.05],
}


def _getch():
    """Read one key from the terminal (cbreak mode)."""
    import termios
    import tty

    fd = sys.stdin.fileno()
    old = termios.tcgetattr(fd)
    try:
        tty.setcbreak(fd)
        return sys.stdin.read(1)
    finally:
        termios.tcsetattr(fd, termios.TCSADRAIN, old)


def teleop_loop(port: int = 7777, hostname: str = "127.0.0.1",
                continuous: bool = False):
    context, socket = connect_pair(port, hostname=hostname)
    printGreen("Teleop: w/a/s/d to move, r to reset, q to quit")
    socket.send_json({"command": "reset"})
    state = socket.recv_json()
    recvMatrix(socket)
    printGreen(f"Initial position: {state['position']}")
    while True:
        key = _getch().lower()
        if key == "q":
            socket.send_json({"command": "exit"})
            socket.close()
            return
        if key == "r":
            socket.send_json({"command": "reset"})
        elif key in KEY_TO_DISCRETE:
            if continuous:
                socket.send_json({"command": "action",
                                  "action": KEY_TO_CONTINUOUS[key],
                                  "is_discrete": False})
            else:
                socket.send_json({"command": "action",
                                  "action": KEY_TO_DISCRETE[key],
                                  "is_discrete": True})
        else:
            printYellow(f"Unmapped key: {key!r}")
            continue
        state = socket.recv_json()
        recvMatrix(socket)
        printGreen(
            f"pos={np.round(state['position'], 3).tolist()} "
            f"reward={state['reward']}"
        )


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--port", type=int, default=7777)
    parser.add_argument("--hostname", type=str, default="127.0.0.1")
    parser.add_argument("--continuous", action="store_true")
    args = parser.parse_args(argv)
    teleop_loop(args.port, args.hostname, args.continuous)


if __name__ == "__main__":
    main()
