"""The plain reference of every configuration: exact nearest neighbours
and exact distances in plain PyTorch (`exact_knn`), and the control that
puts it in the program's place one precision lower (`control`). Nothing
here imports `jax`, `raft_tpu` or anything of `raft_tpu_torch`, and
nothing here takes a table, weight or index that the program made."""
