"""The Omnirobot simulator behind the robot protocol (counterpart of
srl_tpu/real_robots/sim_server.py).

Serves one ``envs.omnirobot.OmniRobotEnv`` on the card over a ZMQ PAIR
socket, speaking the protocol of the real robot's server: ``{"command":
"reset"}`` or ``{"command": "action", "action": a, "is_discrete": b}`` in,
a JSON state (``reward``, ``position``, ``target_pos``) and the 224x224x3
uint8 frame out; ``{"command": "exit"}`` stops it. So
``remote_env.OmniRobotRemoteEnv`` (of either package) drives it end to end
with no robot and no ROS.

Random numbers come from a ``torch.Generator`` on the env's device, seeded
with ``seed``, or from ``env_draws``: an iterable whose items are, in order, the noise of each
reset (``draw_reset_noise``) and step (``draw_step_noise``) the server
serves. Fed the numbers the reference's server draws from its keys, it
sends the same states and frames, bit for bit.

Run:  python -m srl_tpu_torch.real_robots.sim_server [--port 7777] [--device cpu]
"""
from __future__ import annotations

import argparse
from typing import Iterable, Optional

import torch

from srl_tpu_torch.core.device import resolve_device
from srl_tpu_torch.envs.omnirobot import OmniRobotEnv
from srl_tpu_torch.real_robots.transport import connect_pair, sendMatrix
from srl_tpu_torch.utils.logging import printGreen


class OmniRobotSimServer:
    def __init__(self, port: int = 7777, seed: int = 0, noise: bool = True, device="cuda",
                 env_draws: Optional[Iterable[dict]] = None):
        self.device = resolve_device(device)
        self.env = OmniRobotEnv(srl_model="raw_pixels", noise=noise)
        self.gen = torch.Generator(device=self.device).manual_seed(seed)
        self._draws = iter(env_draws) if env_draws is not None else None
        self.state = None
        self.context, self.socket = connect_pair(port, server=True)
        printGreen(f"Omnirobot simulator server listening on port {port} ({self.device})")

    def _noise(self, draw) -> dict:
        if self._draws is None:
            return draw(self.gen, 1)
        return {k: torch.as_tensor(v, device=self.device) for k, v in next(self._draws).items()}

    def _send_state(self, reward: float):
        self.socket.send_json({
            "reward": reward,
            "position": self.state.robot_pos[0].tolist(),
            "target_pos": self.state.target_pos[0].tolist(),
        })
        sendMatrix(self.socket, self.env.render_pixels(self.state)[0].cpu().numpy())

    def serve_forever(self):
        while True:
            msg = self.socket.recv_json()
            command = msg.get("command", "")
            if command == "reset":
                self.state = self.env.apply_reset(self._noise(self.env.draw_reset_noise))
                self._send_state(0.0)
            elif command == "action":
                if msg.get("is_discrete", True):
                    action = torch.tensor([int(msg["action"])], dtype=torch.int32)
                else:
                    action = torch.tensor([msg["action"]], dtype=torch.float32)
                self.state, reward, _ = self.env.apply_step(
                    self.state, action.to(self.device), self._noise(self.env.draw_step_noise))
                self._send_state(float(reward[0]))
            elif command == "exit":
                printGreen("Received exit signal, quitting...")
                self.socket.close()
                return
            else:
                raise ValueError(f"Unknown command: {msg}")


def main(argv=None):
    parser = argparse.ArgumentParser(description="Omnirobot simulator server (PyTorch port)")
    parser.add_argument("--port", type=int, default=7777)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--no-noise", action="store_true")
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = parser.parse_args(argv)
    OmniRobotSimServer(args.port, args.seed, noise=not args.no_noise,
                       device=args.device).serve_forever()


if __name__ == "__main__":
    main()
