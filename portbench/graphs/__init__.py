"""Graph generators, one module a generator, each with
``make(params, seed, device) -> (rows, cols, vals, n)``: int64 row and
column indices and float32 values of an n × n matrix, made on ``device``
with a ``torch.Generator``, from the run's ``seed`` where the seed does
not change the work, else from a seed of the configuration's own. Entry
(i, j) is the edge j → i."""
