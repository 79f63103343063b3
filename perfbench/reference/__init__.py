"""Plain fp32 references, one per family, written from the published model
descriptions.  They import nothing of ``repro_torch``."""
