"""Coloured console logging and small host helpers (counterpart of
srl_tpu/utils/logging.py)."""
from __future__ import annotations

import os

import numpy as np


def _c(code: int, text: str) -> str:
    return f"\033[{code}m{text}\033[0m"


def printGreen(text: str):
    print(_c(32, text))


def printYellow(text: str):
    print(_c(33, text))


def printRed(text: str):
    print(_c(31, text))


def printBlue(text: str):
    print(_c(34, text))


def createFolder(path: str, exist_warning: str = None):
    """``os.makedirs(path)``; an existing folder prints ``exist_warning``
    when one is given."""
    try:
        os.makedirs(path)
    except OSError:
        if exist_warning:
            printYellow(exist_warning)


def softmax(x):
    """Softmax over the last axis, shifted by the maximum."""
    e = np.exp(x - np.max(x, axis=-1, keepdims=True))
    return e / e.sum(axis=-1, keepdims=True)
