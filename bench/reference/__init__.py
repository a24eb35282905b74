"""The plain reference of the benchmark's training cells: a frozen,
independent restatement in plain PyTorch of what one DiLoCo outer step
computes (``model`` the forward and loss, ``optim`` AdamW and the
Nesterov outer step, ``codec`` the int8 codec and the ring mean,
``diloco`` the steps that tie them together).

It reads only the configuration and traffic files and the tensors the
benchmark hands it; it imports nothing of the program under test.
"""
