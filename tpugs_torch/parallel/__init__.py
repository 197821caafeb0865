"""Distribution over a ("data", "gauss") mesh of torch.distributed ranks,
one rank per card: camera-batch data parallelism, gaussian sharding and
the tile-sharded exchange, and the distributed Trainer's steps."""
