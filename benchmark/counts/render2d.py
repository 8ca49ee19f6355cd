"""Bytes of the MobileRobot sprite compositor (``render_mobile_robot``),
each input read once and the output written once: the scene rows (robot,
two targets, two flags: 8 float32 an env), the two coordinate vectors and
the RGB background, and the uint8 frames. It computes by compares and
selects; no operation count follows from its inputs and outputs, so its
bound is the bytes'."""


def bytes_moved(num_envs: int, height: int, width: int, channels: int = 3) -> int:
    return (num_envs * 8 * 4 + (height + width) * 4 + height * width * 3
            + num_envs * height * width * channels)


def flops(num_envs: int, height: int, width: int, channels: int = 3) -> int:
    return 0
