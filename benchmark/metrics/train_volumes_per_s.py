"""Volumes every card's steps completed in the window, over the window's
seconds (start to the slowest card's last step-end CUDA event) and the
number of cards."""


def read(run):
    return run.volumes_per_s
