"""The plain reference that decides ``correct``: float64 PyTorch and NumPy,
importing nothing of the program.

It recomputes, from what the taps (``isacbench/capture.py``) kept, each stage
boundary of the timed path: the CDL channel's slot response as a sum over
rays, and the received grid from the transmitted grids, the link budget and
every co-channel cell's interference (``channel.py``); each stage of a
receive call from the DM-RS references to the transport block and its CRC
(``rxchain.py``); the layered min-sum decode of the decoder's input
(``ldpc.py``); and the range-Doppler map of the echo (``rdm.py``).
``check.py`` compares and holds each number to its limit in ``limits.json``.
"""
