"""One encoder or decoder layer's model FLOPs of each block family other
than the transformer (``model._fft_layer``), one module a family, named as
the configuration's ``building_block.block_type``: ``layer(n, d, blk)`` over
n positions at width d, ``blk`` the family's block of the configuration,
under ``model``'s rules."""
