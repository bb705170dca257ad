"""Patch-sharded solves over ``torch.distributed`` (one rank per device):
the Morton partition (:mod:`.partition`), the mesh and its collectives
(:mod:`.sharding`), the cut-face halo engine (:mod:`.halo`) and the
gathered engine of ``comm="pjit"`` (:mod:`.gathered`)."""
