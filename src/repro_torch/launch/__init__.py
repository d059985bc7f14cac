"""Launch-time planning of the port: the production mesh
(``launch.mesh``), the cost probe (``launch.costs``) and the dry-run of
every (arch × shape × mesh) cell (``python -m repro_torch.launch.dryrun``),
none of which needs a card."""
