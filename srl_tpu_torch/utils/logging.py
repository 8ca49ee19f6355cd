"""Coloured console logging (counterpart of srl_tpu/utils/logging.py)."""
from __future__ import annotations


def printGreen(text: str):
    print(f"\033[32m{text}\033[0m")


def printYellow(text: str):
    print(f"\033[33m{text}\033[0m")
