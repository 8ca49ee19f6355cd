"""Bytes of the Kuka ray tracer (``render_kuka``), each input read once and
the output written once: the state a frame depends on (7 joint angles and
each button's position, float32) and the uint8 frames at the traced size.
How many ray-primitive tests a tracer makes depends on how it culls, not on
its inputs and outputs, so its bound is the bytes'."""


def bytes_moved(num_envs: int, height: int, width: int, n_buttons: int = 1,
                channels: int = 3) -> int:
    return num_envs * (7 + 3 * n_buttons) * 4 + num_envs * height * width * channels


def flops(num_envs: int, height: int, width: int, n_buttons: int = 1,
          channels: int = 3) -> int:
    return 0
