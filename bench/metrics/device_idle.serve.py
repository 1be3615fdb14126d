"""Percent of the profiled steps in which no kernel ran on the card."""

from bench.harness.view import idle


def read(v):
    return idle(v.slice)
