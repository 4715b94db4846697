"""The reference's encoder and decoder stacks of the block families other
than the transformer (which ``fs2.py`` holds), one module a family, named
as the configuration's ``building_block.block_type``.  Each gives

    stack(P, prefix, x, mask, blk, n_layers, side, drop, train) -> x

``x`` (B, T, d) before positions, ``mask`` (B, T) the valid positions,
``blk`` the family's block of the configuration, ``side`` "encoder" or
"decoder" (its heads and dropout rate), ``drop`` the reference's
``Dropout``, ``train`` batch statistics for a family with BatchNorm."""
