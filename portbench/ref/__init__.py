"""The benchmark's plain reference: a frozen copy of the port's plain
PyTorch renderer (scene compiler, Halton sampler, camera, MIS path
integrator, lobes, lights, box film), with every ray tested against every
primitive (render.py) in place of the port's traversal kernels, cluster
tables and recorded chunk programs.

It imports nothing of the port and takes nothing the port made: it
compiles the scene files itself, makes its own Halton permutations, and
renders its own target. Later changes to the port do not reach it, so a
port that drifts from what these files compute shows as a gap in the
benchmark's `correct` check.
"""
