# Query streams for the serving path (copy of the reference's workload module).
