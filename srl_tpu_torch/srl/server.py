"""The SRL training service (counterpart of srl_tpu/srl/server.py).

Answers the HELLO / LEARN / READY / ERROR / EXIT commands of
``srl_tpu_torch.srl.client`` on a ZMQ PAIR socket. LEARN trains the named
encoder on the dataset folder through
``experiments.train_srl.train_srl_model``, on the card unless the server
was started with ``--device cpu``, and answers READY with the checkpoint's
path; a LEARN that fails answers ERROR with the message, and the server
goes on serving. EXIT stops it.

Run:  python -m srl_tpu_torch.srl.server [--port 7778] [--device cpu]
"""
from __future__ import annotations

import argparse
import os
import traceback

from srl_tpu_torch.core.device import resolve_device
from srl_tpu_torch.real_robots.transport import connect_pair
from srl_tpu_torch.srl.client import SRL_SERVER_PORT, Command
from srl_tpu_torch.utils.logging import printGreen, printRed


def serve(port: int = SRL_SERVER_PORT, device="cuda"):
    """Serve on ``port`` until EXIT; encoders train on ``device``."""
    device = resolve_device(device)
    context, socket = connect_pair(port, server=True)
    printGreen(f"SRL training server listening on port {port} ({device})")
    while True:
        msg = socket.recv_json()
        command = Command(msg["command"])
        if command == Command.HELLO:
            socket.send_json({"command": Command.READY.value})
        elif command == Command.LEARN:
            try:
                from srl_tpu_torch.experiments.train_srl import train_srl_model

                path = train_srl_model(
                    msg["data_folder"],
                    msg.get("srl_model", "autoencoder"),
                    state_dim=msg.get("state_dim", 3),
                    epochs=msg.get("epochs", 5),
                    log_dir=msg.get("log_dir", os.path.join(msg["data_folder"], "srl_model")),
                    device=device,
                )
                socket.send_json({"command": Command.READY.value, "path": path})
            except Exception as e:
                traceback.print_exc()
                socket.send_json({"command": Command.ERROR.value, "error": str(e)})
        elif command == Command.EXIT:
            printGreen("SRL server exiting")
            socket.close()
            return
        else:
            printRed(f"Unknown command {msg}")
            socket.send_json({"command": Command.ERROR.value})


def main(argv=None):
    parser = argparse.ArgumentParser(description="SRL training server (PyTorch port)")
    parser.add_argument("--port", type=int, default=SRL_SERVER_PORT)
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = parser.parse_args(argv)
    serve(args.port, args.device)


if __name__ == "__main__":
    main()
