"""Small math helpers."""

import math


def inverse_sigmoid(x: float) -> float:
    return math.log(x / (1.0 - x))
