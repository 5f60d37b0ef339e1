"""Command-line launchers of the port, after ``repro.launch``:
``python -m repro_torch.launch.train`` and
``python -m repro_torch.launch.serve`` (host mode, one card or the CPU),
and the one-device dry run ``python -m repro_torch.launch.dryrun``
(``specs``: the inputs on ``meta``), and the meshes of a world of ranks
(``mesh``: ``make_dev_mesh``, ``make_fleet_mesh``,
``make_production_mesh``).  The production-mesh paths of the launchers
(``--mesh pod|multipod``) are not ported yet and raise (ROADMAP A8.4b);
``--dry-run`` in host mode serves or trains as usual, as the
reference's does."""
