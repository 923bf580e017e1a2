"""The port's tours 04-07 against the JAX package's, as
``test_torch_examples.py`` holds 01-03 (that file says how): the mesh,
process and ring tours, apart so that the two halves run on two
workers."""

import pytest

from test_torch_examples import NAMES, check_lines, check_main

REST = NAMES[3:]


@pytest.mark.parametrize("name", REST)
def test_tour_prints_the_jax_tours_lines(name):
    check_lines(name)


@pytest.mark.parametrize("name", REST)
def test_main_returns_what_its_lines_carry(name, capfd):
    check_main(name, capfd)
