# Step builders of the port: serving (prefill, decode).
