"""The benchmark's plain reference: PyTorch and numpy only.

It imports nothing of the program under test and takes nothing the program
made.  The benchmark hands it the same raw inputs it hands the program
(weights it made from the seed, frames, rendered net outputs), and it works
out everything else again: the CNN outputs in float32 (`cnn`), the decode
and the people (`decode`, `assembly`), the face and hand crops and their
keypoints (`topdown`).  Where it needs the port's plain arithmetic it holds
a frozen copy of it, so a later change to the program is judged against
the arithmetic as it stands here.
"""
