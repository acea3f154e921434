"""The port's command-line tools: ``train`` and ``test``, the single-image
``demo``, ``validate_hybrid``, the checkpoint tools (``export_torch``,
``publish_model``, ``fuse_conv_bn``), ``print_config``,
``browse_dataset``, ``visualize_results``, and the measurement scripts
(``profile_*``, run on the card)."""
