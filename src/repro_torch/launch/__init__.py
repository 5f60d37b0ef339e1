"""Command-line launchers of the port, after ``repro.launch``:
``python -m repro_torch.launch.train`` and
``python -m repro_torch.launch.serve`` (host mode, one card or the CPU),
and the one-device dry run ``python -m repro_torch.launch.dryrun``
(``specs``: the inputs on ``meta``).  The production-mesh paths
(``--mesh pod|multipod``) need more than one device and raise (ROADMAP
A8.4); ``--dry-run`` in host mode serves or trains as usual, as the
reference's does."""
