"""Raw-signal data substrate: simulation, datasets, streaming reader
(numpy only — identical copies of the reference package's modules)."""
