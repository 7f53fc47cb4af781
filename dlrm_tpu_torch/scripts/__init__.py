"""The port's twins of the repository's scripts: the MLPerf proxy run, the
rank launcher, the golden-log comparator and the shell scripts
(dlrm_tpu_torch/scripts/*.sh), each running the port's trainers."""
