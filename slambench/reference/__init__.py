"""The plain reference that judges a run: numpy and plain PyTorch only.

It imports nothing of the system under test. ``frontend`` works a frame's
features out again from the benchmark's own frame (orb32's pyramid, FAST-9
with 3x3 non-maximum suppression and steered BRIEF; sift128's Gaussian
scale space, dominant orientation and 4x4x8 histograms), following the
published description of the port's extractors; ``geometry`` holds the
similarity alignment and the ground-truth tests of poses, map points and
matched observations.
"""
