"""Model assembly for the port: the dense decoder family over a paged KV
cache (``registry.build_model``), its blocks (``transformer``), the
layer-group loop (``stacked``) and the attention oracles (``attention``)."""
