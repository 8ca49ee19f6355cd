"""ZMQ transport for the robot bridges (counterpart of
srl_tpu/real_robots/transport.py).

The wire format is the reference's: a JSON metadata frame with the array's
``dtype`` and ``shape``, then its raw buffer, as one multipart message on a
PAIR socket. So a client of either package talks to a server of the other.
This is host code: arrays cross it as numpy, and a caller moves them to the
card itself.
"""
from __future__ import annotations

import numpy as np

try:
    import zmq
except ImportError:  # pragma: no cover - pyzmq is installed where the servers run
    zmq = None


def recvMatrix(socket) -> np.ndarray:
    """Receive a numpy array (JSON metadata, then the raw buffer)."""
    metadata = socket.recv_json()
    msg = socket.recv(copy=True, track=False)
    arr = np.frombuffer(memoryview(msg), dtype=metadata["dtype"])
    return arr.reshape(metadata["shape"])


def sendMatrix(socket, mat: np.ndarray):
    """Send a numpy array with its metadata as one multipart message."""
    metadata = dict(dtype=str(mat.dtype), shape=mat.shape)
    socket.send_json(metadata, flags=zmq.SNDMORE)
    return socket.send(np.ascontiguousarray(mat), flags=0, copy=True, track=False)


def getActions(delta_pos: float, n_actions: int) -> np.ndarray:
    """The discrete (dx, dy, dz) action table: single-axis moves of
    +-delta_pos."""
    possible = [i * delta_pos for i in range(-1, 2)]
    actions = []
    for dx in possible:
        for dy in possible:
            for dz in possible:
                if dx == 0 and dy == 0 and dz == 0:
                    continue
                if abs(dx) + abs(dy) + abs(dz) > delta_pos:
                    continue
                actions.append([dx, dy, dz])
    assert len(actions) == n_actions, f"Wrong number of actions: {len(actions)}"
    return np.array(actions)


def connect_pair(port: int, server: bool = False, hostname: str = "127.0.0.1"):
    """A PAIR socket that binds (server) or connects (client); returns
    (context, socket)."""
    if zmq is None:
        raise ImportError("pyzmq is not installed: the robot bridges need it")
    context = zmq.Context()
    socket = context.socket(zmq.PAIR)
    if server:
        socket.bind(f"tcp://*:{port}")
    else:
        socket.connect(f"tcp://{hostname}:{port}")
    return context, socket
