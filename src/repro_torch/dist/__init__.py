"""Device layouts and collectives: ``mesh`` maps a flat device count onto
the Swapped Dragonfly D3(K, M); ``collectives`` holds the cached program
getters of the paper's four algorithms."""
