# Step builders of the port: serving (prefill, decode) and training
# (the train step, AdamW, checkpoints, input specs).
