"""Several devices for the port: the process group (dist) and the N-rank dry run
(dryrun), counterparts of parseq_tpu/parallel and __graft_entry__.dryrun_multichip."""
