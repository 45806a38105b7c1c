"""Command-line entry points of the port, and what they drive:

- ``serve``, ``fleet``, ``train``: the serving launcher, the fleet
  harness's launcher, the training launcher;
- ``mesh``: the production meshes on the cards, and the dry run's meshes
  of the same shapes on ``meta`` positions;
- ``cells``: the (arch × shape) cells of the reference, built on
  ``meta`` (the dry run), the CPU or the card;
- ``op_cost``: a run's flops, bytes, collective bytes and peak memory,
  counted over the aten ops it dispatches (the role of the reference's
  ``hlo_cost.py``, which parses XLA's HLO: the port has none);
- ``dryrun``: every cell counted on ``meta`` over 256 or 512 positions,
  a JSON record each;
- ``roofline``: the records' roofline terms at the H100's peaks.
"""
