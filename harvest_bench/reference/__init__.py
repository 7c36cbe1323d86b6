"""Plain references: each family's forward pass in float32 with plain
``torch`` operations, no kernel, no cache and no batching. They import
nothing of the port. A configuration file names its family's module in
``reference``; the module's ``logits(weights, hp, seqs, n_last, prec)``
gives each sequence's logits at its last ``n_last`` positions."""
