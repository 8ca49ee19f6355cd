"""Client of the SRL training service (counterpart of srl_tpu/srl/client.py).

A ZMQ PAIR connection speaking the HELLO / LEARN / READY / ERROR / EXIT
commands: an RL run asks the service to train an encoder on a recorded
dataset and waits for the checkpoint's path. ``srl_tpu_torch.srl.server``
is the service; the messages are the reference's, so either package's
client talks to either package's server.
"""
from __future__ import annotations

import time
from enum import Enum

from srl_tpu_torch.real_robots.transport import connect_pair
from srl_tpu_torch.utils.logging import printGreen, printRed, printYellow

SRL_SERVER_PORT = 7778


class Command(Enum):
    HELLO = 0
    LEARN = 1
    READY = 2
    ERROR = 3
    EXIT = 4


class SRLClient:
    def __init__(self, data_folder: str, port: int = SRL_SERVER_PORT,
                 hostname: str = "127.0.0.1"):
        self.data_folder = data_folder
        self.context, self.socket = connect_pair(port, hostname=hostname)
        self.waitReady()

    def waitReady(self):
        self.socket.send_json({"command": Command.HELLO.value})
        msg = self.socket.recv_json()
        assert msg["command"] == Command.READY.value, f"SRL server not ready: {msg}"
        printGreen("Connected to SRL server")

    def sendLearnSignal(self, srl_model: str = "autoencoder", state_dim: int = 3,
                        epochs: int = 5):
        self.socket.send_json(
            {"command": Command.LEARN.value, "data_folder": self.data_folder,
             "srl_model": srl_model, "state_dim": state_dim, "epochs": epochs})

    def waitForSRLModel(self, timeout_s: float = 600.0):
        """Wait up to ``timeout_s`` for the server's answer to LEARN; returns
        (True, checkpoint path) on READY, (False, None) on ERROR or when the
        time runs out."""
        start = time.time()
        while time.time() - start < timeout_s:
            if self.socket.poll(1000):
                msg = self.socket.recv_json()
                if msg["command"] == Command.READY.value:
                    printGreen(f"SRL model trained: {msg.get('path')}")
                    return True, msg.get("path")
                if msg["command"] == Command.ERROR.value:
                    printRed(f"SRL training failed: {msg.get('error')}")
                    return False, None
        printYellow("Timed out waiting for the SRL model")
        return False, None

    def close(self):
        self.socket.send_json({"command": Command.EXIT.value})
        self.socket.close()
