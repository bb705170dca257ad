"""Patch-sharded solves over ``torch.distributed`` (one rank per device):
the Morton partition (:mod:`.partition`), the mesh and its collectives
(:mod:`.sharding`) and the cut-face halo engine (:mod:`.halo`)."""
