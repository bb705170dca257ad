"""Host seconds of ``domain.DomainHierarchy`` (tables of every level)."""


def read(run):
    return run.setup.get("hierarchy_s")
