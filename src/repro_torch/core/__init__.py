"""Tables, local and distributed relational operators, and the virtual mesh."""
