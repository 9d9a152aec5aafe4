"""The frozen stream generator gives the program's streams bit for bit."""
import numpy as np

from cascade_bench import streams
from repro_torch.sim import synthetic


def test_streams_equal_the_programs():
    seed = 2 ** 31 + 17
    mine = streams.device_streams(7, 300, 0.7464, 0.8341, seed)
    theirs = synthetic.device_streams(7, 300, 0.7464, 0.8341, seed)
    for key in ("confidence", "correct_light"):
        np.testing.assert_array_equal(mine[key], theirs[key])
    np.testing.assert_array_equal(mine["correct_heavy"],
                                  theirs["correct_heavy"][..., 0])
